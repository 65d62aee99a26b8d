"""Quantized-op API: one entry point per op.

``qdot`` (packed sub-byte GEMM, eq. 2-4; a `SegmentedLinearParams`
routes to the mixed-operand GEMM, op ``qdot_mixed``) and ``qconv``
(fused implicit-GEMM HWC conv) pad and pack on the fly and call the
kernel wrappers, which choose by the tensor's device: CUDA tensors
launch the hand-written Hopper kernel (csrc/), CPU tensors run its plain
torch version. That is the only dispatch; nothing falls back from one to
the other.

A backend *name* survives where a plan JSON or the CLI carries one, and
in the tune cache's keys and the op counters: ``cuda`` or ``torch``, the
one the tensor's device runs. `check_backend` holds a plan's name
against the device the net is placed on.

**Per-call resolution** (`_resolve_call`), with one tune-cache probe
(`repro_torch.kernels.tune`) per call:
- pipeline (the Mac&Load knob, STAGES of the kernels): explicit
  ``pipeline=`` (a plan's pipeline arrives this way from
  `vision/layers.py`) -> ``REPRO_QPIPELINE`` -> the tuned winner for
  this (op, shape, bits, backend) -> ``'off'``;
- launch (the uniform GEMM's K split and register budget): tuned ->
  planned (`gemm_launch_plan`). ``qdot_mixed`` looks up the pipeline
  only, keyed by its widest segment width; its K split and the conv's
  tile are not runtime knobs.

**The dense layer's GEMM** (`int_gemm`, the reference's
``xla_int_gemm``) bypasses the op registry as the reference's does: no
tune-cache probe, no dispatch event, no op counter. Its pipeline is
explicit -> ``REPRO_QPIPELINE`` -> 'off'; its launch the planned one.

**Observability.** With ``REPRO_OBS=1`` (`repro_torch.obs`), every call
records one dispatch event (the choice and where each field came from,
queryable via `repro_torch.obs.dispatch_log()`), bumps the per-(op,
bits, backend, pipeline) MAC/byte counters and runs inside a
``cat='kernel'`` span that waits for the device, so the kernel's device
time lands inside it. Disabled (the default), the instrumentation is a
single predicate per call.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import packing
from repro_torch.core.quantize import SegmentedLinearParams
from repro_torch.kernels import tune
from repro_torch.kernels.common import check_pipeline
from repro_torch.kernels.qconv.kernel import qconv2d_fused
from repro_torch.kernels.qmatmul.kernel import (qmatmul_packed,
                                                qmatmul_segmented)
from repro_torch.obs import counters as obs_counters
from repro_torch.obs import env as obsenv
from repro_torch.obs import trace as obs

# the backend a plan or the CLI may name, by the device it runs on
BACKENDS = ("cuda", "torch")
ENV_PIPELINE = "REPRO_QPIPELINE"


def check_backend(backend: Optional[str],
                  device: Union[torch.device, str]) -> None:
    """Raise unless ``backend`` (None, or a name from a plan or the CLI)
    is the one that runs on ``device``: 'cuda' on a CUDA device, 'torch'
    on the CPU."""
    if backend is None:
        return
    if backend not in BACKENDS:
        raise ValueError(
            f"backend {backend!r} is not a backend of this port; the "
            f"port's backends are {list(BACKENDS)}")
    device = torch.device(device)
    if backend != device_backend(device):
        raise ValueError(
            f"backend {backend!r} does not run on {device} ('cuda' runs "
            "CUDA tensors, 'torch' CPU tensors)")


def device_backend(device: torch.device) -> str:
    """The backend that runs tensors on ``device``."""
    return "cuda" if device.type == "cuda" else "torch"


def resolve_pipeline(pipeline: Optional[str] = None,
                     entry: Optional[dict] = None) -> str:
    """Explicit -> ``REPRO_QPIPELINE`` -> the tuned ``entry`` (a tune
    cache entry, or None) -> 'off'. The env is read (and so validated)
    only when no explicit pipeline decided."""
    return check_pipeline(pipeline or obsenv.get(ENV_PIPELINE)
                          or (entry["pipeline"] if entry else None)
                          or "off")


def _resolve_call(op: str, shape, a_bits: int, w_bits: int, backend: str,
                  pipeline: Optional[str]):
    """One tune-cache probe; the call's (launch, pipeline) by the module
    docstring's precedence; with observability on, one dispatch event
    with each field's provenance."""
    entry = tune.get_entry(op, shape, a_bits, w_bits, backend)
    chosen = resolve_pipeline(pipeline, entry)
    launch = None if entry is None else entry["launch"]
    if obs.enabled():
        env = None if pipeline is not None else obsenv.get(ENV_PIPELINE)
        obs.dispatch_event(
            op=op, shape=tuple(int(s) for s in shape), a_bits=int(a_bits),
            w_bits=int(w_bits), backend=backend, backend_source="device",
            pipeline=chosen,
            pipeline_source=("explicit" if pipeline is not None
                             else "env" if env is not None
                             else "tuned" if entry is not None
                             else "default"),
            env_pipeline=env, launch=launch,
            launch_source="tuned" if launch is not None else "planned",
            tune_cache_hit=entry is not None, tune_winner=entry)
    return launch, chosen


def _run_counted(op: str, shape, a_bits: int, w_bits: int, backend: str,
                 pipeline: str, thunk,
                 w_packed_bytes: Optional[int] = None):
    """Run the kernel call. With observability on, bump the (op, bits,
    backend, pipeline) MAC/byte counters and wrap the run in a
    ``cat='kernel'`` span that waits for the device, so the device time
    lands inside it; off, it is a bare call."""
    if not obs.enabled():
        return thunk()
    costs = obs_counters.record(op, shape, a_bits, w_bits, backend=backend,
                                pipeline=pipeline,
                                w_packed_bytes=w_packed_bytes)
    with obs.span(op, cat="kernel", backend=backend, pipeline=pipeline,
                  a_bits=int(a_bits), w_bits=int(w_bits),
                  shape=tuple(int(s) for s in shape), macs=costs["macs"],
                  packed_bytes=costs["packed_bytes"]) as sp:
        return sp.sync(thunk())


def qdot(params, x_hat: torch.Tensor, *, epilogue: str = "int", scale=1.0,
         pipeline: Optional[str] = None) -> torch.Tensor:
    """Quantized dot: integer images x_hat (..., K_logical) int8 x packed
    weights (`QuantizedLinearParams` or `SegmentedLinearParams`). Leading
    dims are flattened for the GEMM and restored; K is padded to CHUNK
    and packed on the fly."""
    lead = x_hat.shape[:-1]
    x2 = packing.pad_to_chunk(x_hat.reshape(-1, x_hat.shape[-1]), axis=-1)
    xp = packing.pack(x2, params.a_bits, axis=-1)
    out = qdot_packed(params, xp, epilogue=epilogue, scale=scale,
                      pipeline=pipeline)
    return out.reshape(*lead, out.shape[-1])


def qdot_packed(params, x_packed: torch.Tensor, *, epilogue: str = "int",
                scale=1.0, pipeline: Optional[str] = None) -> torch.Tensor:
    """`qdot` over already-packed activations (M, K_pad/pf_a). The shape
    key is (M, K padded to CHUNK, N)."""
    backend = device_backend(x_packed.device)
    m = x_packed.shape[0]
    k = x_packed.shape[1] * packing.pack_factor(params.a_bits)
    if isinstance(params, SegmentedLinearParams):
        shape = (m, k, params.segmap.n)
        w_key = params.segmap.widths()[0]   # widest width present
        _, pipeline = _resolve_call("qdot_mixed", shape, params.a_bits,
                                    w_key, backend, pipeline)
        return _run_counted(
            "qdot_mixed", shape, params.a_bits, w_key, backend, pipeline,
            lambda: _qdot_mixed(params, x_packed, epilogue=epilogue,
                                scale=scale, pipeline=pipeline),
            w_packed_bytes=params.segmap.packed_bytes(params.k_logical))
    shape = (m, k, params.w_packed.shape[1])
    launch, pipeline = _resolve_call("qdot", shape, params.a_bits,
                                     params.w_bits, backend, pipeline)
    return _run_counted(
        "qdot", shape, params.a_bits, params.w_bits, backend, pipeline,
        lambda: qdot_run(params, x_packed, epilogue=epilogue, scale=scale,
                         pipeline=pipeline, launch=launch))


def qdot_run(params, x_packed: torch.Tensor, *, epilogue: str, scale,
             pipeline: str, launch: Optional[dict] = None) -> torch.Tensor:
    """The uniform GEMM's wrapper call at a resolved pipeline and launch,
    with no lookup and no recording (`kernels/tune.py` times it)."""
    return qmatmul_packed(
        x_packed, params.w_packed, params.kappa, params.lam, params.m,
        a_bits=params.a_bits, a_signed=params.a_signed,
        w_bits=params.w_bits, d=params.d, out_bits=params.out_bits,
        epilogue=epilogue, scale=scale, pipeline=pipeline,
        k_logical=params.k_logical, launch=launch)


def _pad_channels(v: Optional[torch.Tensor], n_pad: int):
    if v is None:
        return None
    return torch.nn.functional.pad(v, (0, n_pad - v.shape[-1]))


def _qdot_mixed(params: SegmentedLinearParams, x_packed, *, epilogue,
                scale, pipeline: str, out_dtype=None) -> torch.Tensor:
    """Mixed-operand GEMM: zero-pad the ragged tail panel of the
    segmented container to a full CHUNK (`pad_segmented`; the artifact
    itself stays exact-bytes) and the per-channel vectors with it, run
    `qmatmul_segmented`, slice back to N."""
    n = params.segmap.n
    w_flat, segmap = packing.pad_segmented(params.w_flat, params.segmap,
                                           params.k_logical)
    n_pad = segmap.n
    kappa, lam, m_mul = (_pad_channels(v, n_pad)
                         for v in (params.kappa, params.lam, params.m))
    if not isinstance(scale, (int, float)):
        scale = torch.as_tensor(scale)
        if scale.dim() == 1:
            scale = _pad_channels(scale, n_pad)
    out = qmatmul_segmented(
        x_packed, w_flat, segmap, kappa, lam, m_mul,
        k_logical=params.k_logical, a_bits=params.a_bits,
        a_signed=params.a_signed, d=params.d, out_bits=params.out_bits,
        epilogue=epilogue, scale=scale, pipeline=pipeline,
        out_dtype=out_dtype)
    return out if n_pad == n else out[:, :n]


def int_gemm(x_q: torch.Tensor, w, *, a_bits: int,
             w_bits: Optional[int] = None, scale, out_dtype=None,
             pipeline: Optional[str] = None,
             k_logical: Optional[int] = None) -> torch.Tensor:
    """The dense layer's integer GEMM with the dequant epilogue (the
    reference's ``xla_int_gemm(..., epilogue='dequant')``).

    ``x_q``: (..., K_pad) int8 codes on the *signed* ``a_bits`` grid, K
    zero-padded to CHUNK; they are packed at ``a_bits`` with
    ``a_signed=True``. ``w``: a packed (K_pad/pf_w, N) int8 tensor at
    ``w_bits``, contracted over the first ``k_logical`` values of K
    (default all), or a `SegmentedLinearParams` (its own widths and K;
    no epilogue vectors needed), which runs the mixed-operand GEMM in
    one launch. ``scale``: scalar or per-channel (N,) float32; the
    output is ``out_dtype`` (bfloat16 by default, or float32). Leading
    dims are flattened for the GEMM and restored.
    """
    lead = x_q.shape[:-1]
    xp = packing.pack(x_q.reshape(-1, x_q.shape[-1]), a_bits, axis=-1)
    pipeline = resolve_pipeline(pipeline)
    if isinstance(w, SegmentedLinearParams):
        out = _qdot_mixed(w, xp, epilogue="dequant", scale=scale,
                          pipeline=pipeline, out_dtype=out_dtype)
    else:
        out = qmatmul_packed(
            xp, w, None, None, None, a_bits=a_bits, a_signed=True,
            w_bits=w_bits, d=0, out_bits=8, epilogue="dequant",
            scale=scale, pipeline=pipeline, k_logical=k_logical,
            out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])


def qconv(params, x_hat: torch.Tensor, *, epilogue: str = "int", scale=1.0,
          pipeline: Optional[str] = None) -> torch.Tensor:
    """Quantized HWC conv: (N, H, W, Cin) int8 images -> (N, Ho, Wo, Cout)
    through the fused implicit-GEMM route. The shape key is (n, h, w, cin,
    fh, fw, stride, padding, cout, groups), Cin the image's real one."""
    if params.groups != 1:
        raise ValueError(
            f"qconv does not support grouped conv (groups={params.groups}); "
            "lower depthwise/grouped layers via "
            "repro_torch.vision.layers.QDepthwiseConv2D (per-group qconv "
            "or block-diagonal im2col + qdot)")
    g = params.gemm
    shape = (*x_hat.shape, params.fh, params.fw, params.stride,
             params.padding, params.cout, params.groups)
    backend = device_backend(x_hat.device)
    _, pipeline = _resolve_call("qconv", shape, g.a_bits, g.w_bits, backend,
                                pipeline)
    return _run_counted(
        "qconv", shape, g.a_bits, g.w_bits, backend, pipeline,
        lambda: qconv_run(params, x_hat, epilogue=epilogue, scale=scale,
                          pipeline=pipeline))


def qconv_run(params, x_hat: torch.Tensor, *, epilogue: str, scale,
              pipeline: str) -> torch.Tensor:
    """The conv's wrapper call at a resolved pipeline, with no lookup and
    no recording (`kernels/tune.py` times it)."""
    g = params.gemm
    return qconv2d_fused(
        x_hat, params.w_packed_fused, g.kappa, g.lam, g.m, fh=params.fh,
        fw=params.fw, stride=params.stride, padding=params.padding,
        cin_pad=params.cin_pad, cout=params.cout, a_bits=g.a_bits,
        a_signed=g.a_signed, w_bits=g.w_bits, d=g.d, out_bits=g.out_bits,
        epilogue=epilogue, scale=scale, pipeline=pipeline)
