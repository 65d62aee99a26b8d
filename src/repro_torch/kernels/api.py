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
tune-cache probe, no dispatch event. Its pipeline is explicit ->
``REPRO_QPIPELINE`` -> 'off'; its launch the planned one. With
observability on it is counted as op ``int_gemm`` at its real K.

**Cluster path** (`qdot_sharded`, `qconv_sharded`; ``mesh=`` on `qdot`
and `qconv`): the paper's N-core cluster (fig. 9) on a
`repro_torch.parallel.mesh.Mesh`. Packed weights and the per-N epilogue
vectors are tensor-parallel over the output features (``model``),
activation rows or images data-parallel over ``data`` (padded to a
multiple, sliced back). K is never split, so every shard runs the whole
eq. 2-4 pipeline at its local shape and the result equals one device's
exactly, with no reduction across shards. Pipeline and launch resolve on
the local shape; the op counters count the global one.

**Attention** (`attention`): the fused attention kernel
(``csrc/attn.cu``), which raises on a call it cannot take;
`attention_takes` says whether a call is the kernel's by its device,
dtype, grad and head widths. It bypasses the op registry: no tune-cache
probe, no dispatch event.

**Observability.** With ``REPRO_OBS=1`` (`repro_torch.obs`), every call
records one dispatch event (the choice and where each field came from,
queryable via `repro_torch.obs.dispatch_log()`), bumps the per-(op,
bits, backend, pipeline) MAC/byte counters and runs inside a
``cat='kernel'`` span that waits for the device, so the kernel's device
time lands inside it. Disabled (the default), the instrumentation is a
single predicate per call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core import packing
from repro_torch.core.quantize import SegmentedLinearParams
from repro_torch.kernels import tune
from repro_torch.kernels.attn.kernel import attention_fused_cuda, attn_plan
from repro_torch.kernels.common import check_pipeline
from repro_torch.kernels.qconv.kernel import qconv2d_fused
from repro_torch.kernels.qmatmul.kernel import (qmatmul_grouped,
                                                qmatmul_packed,
                                                qmatmul_segmented)
from repro_torch.obs import counters as obs_counters
from repro_torch.obs import env as obsenv
from repro_torch.obs import trace as obs
from repro_torch.parallel import mesh as pmesh
from repro_torch.parallel import sharding as shrules
from repro_torch.parallel.mesh import NamedSharding, P, device_put, gather

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
         pipeline: Optional[str] = None, mesh=None) -> torch.Tensor:
    """Quantized dot: integer images x_hat (..., K_logical) int8 x packed
    weights (`QuantizedLinearParams` or `SegmentedLinearParams`). Leading
    dims are flattened for the GEMM and restored; K is padded to CHUNK
    and packed on the fly. With ``mesh=`` the call runs `qdot_sharded`."""
    if mesh is not None:
        if isinstance(params, SegmentedLinearParams):
            raise NotImplementedError(
                "qdot(mesh=...) does not take SegmentedLinearParams: "
                "segment boundaries and the TP output-feature split would "
                "have to be co-aligned; shard per segment above the op "
                "instead")
        return qdot_sharded(params, x_hat, mesh=mesh, epilogue=epilogue,
                            scale=scale, pipeline=pipeline)
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
             k_logical: Optional[int] = None,
             epilogue: str = "dequant") -> torch.Tensor:
    """The dense layer's integer GEMM with the dequant epilogue (the
    reference's ``xla_int_gemm(..., epilogue='dequant')``), or with
    ``epilogue='raw'`` its int32 accumulators (a uniform ``w`` only: a
    row-parallel K-slice, summed across the model positions before one
    dequant).

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
    backend = device_backend(xp.device)
    if isinstance(w, SegmentedLinearParams):
        out = _run_counted(
            "int_gemm", (xp.shape[0], w.k_logical, w.segmap.n), a_bits,
            w.segmap.widths()[0], backend, pipeline,
            lambda: _qdot_mixed(w, xp, epilogue="dequant", scale=scale,
                                pipeline=pipeline, out_dtype=out_dtype),
            w_packed_bytes=w.segmap.packed_bytes(w.k_logical))
    else:
        out = _run_counted(
            "int_gemm", (xp.shape[0], k_logical or x_q.shape[-1],
                         w.shape[1]), a_bits, w_bits, backend, pipeline,
            lambda: qmatmul_packed(
                xp, w, None, None, None, a_bits=a_bits, a_signed=True,
                w_bits=w_bits, d=0, out_bits=8, epilogue=epilogue,
                scale=scale, pipeline=pipeline, k_logical=k_logical,
                out_dtype=None if epilogue == "raw" else out_dtype))
    return out.reshape(*lead, out.shape[-1])


def int_gemm_grouped(x_q: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     counts, *, a_bits: int, w_bits: int, out_dtype=None,
                     pipeline: Optional[str] = None,
                     k_logical: Optional[int] = None) -> torch.Tensor:
    """`int_gemm` over row groups, each with its own weights (a MoE
    layer's held experts): group e, ``counts[e]`` rows of ``x_q`` (R,
    K_pad) in order, against ``w[e]`` (E, K_pad/pf_w, N) and its
    per-channel ``scale[e]`` (E, N), into one (R, N) output
    (`qmatmul_grouped`). Each group's rows equal `int_gemm` on them; with
    observability on each group counts as one ``int_gemm`` call."""
    xp = packing.pack(x_q, a_bits, axis=-1)
    pipeline = resolve_pipeline(pipeline)
    if obs.enabled():
        backend = device_backend(xp.device)
        for c in counts:
            if c:
                obs_counters.record("int_gemm", (c, k_logical or x_q.shape[-1],
                                                 w.shape[-1]), a_bits, w_bits,
                                    backend=backend, pipeline=pipeline)
    return qmatmul_grouped(xp, w, scale, counts, a_bits=a_bits,
                           w_bits=w_bits, pipeline=pipeline,
                           k_logical=k_logical, out_dtype=out_dtype)


def qconv(params, x_hat: torch.Tensor, *, epilogue: str = "int", scale=1.0,
          pipeline: Optional[str] = None, mesh=None) -> torch.Tensor:
    """Quantized HWC conv: (N, H, W, Cin) int8 images -> (N, Ho, Wo, Cout)
    through the fused implicit-GEMM route. The shape key is (n, h, w, cin,
    fh, fw, stride, padding, cout, groups), Cin the image's real one.
    With ``mesh=`` the call runs `qconv_sharded`."""
    if mesh is not None:
        return qconv_sharded(params, x_hat, mesh=mesh, epilogue=epilogue,
                             scale=scale, pipeline=pipeline)
    _check_ungrouped(params)
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


def _check_ungrouped(params):
    if params.groups != 1:
        raise ValueError(
            f"qconv does not support grouped conv (groups={params.groups}); "
            "lower depthwise/grouped layers via "
            "repro_torch.vision.layers.QDepthwiseConv2D (per-group qconv "
            "or block-diagonal im2col + qdot)")


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              mode: str, window=None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention of q (B,S,Hk,G,Dh) over k (B,T,Hk,Dh) and v
    (B,T,Hk,Dv): (B,S,Hk*G*Dv) in v's dtype, from the Hopper kernel
    (``csrc/attn.cu``); raises on a call outside its domain
    (`kernels/attn/kernel.py::refusal`), the layout's included."""
    return attention_fused_cuda(q, k, v, mode=mode, window=window,
                                scale=scale)


def attention_takes(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> bool:
    """Whether `attention` is this call's path: CUDA bf16 tensors, none
    requiring grad, at head widths the kernel has a plan for
    (`attn_plan`). The layout and the mask are not read here: a call
    the kernel takes by these but refuses by those raises."""
    return (all(x.is_cuda and x.dtype == torch.bfloat16
                and not x.requires_grad for x in (q, k, v))
            and attn_plan(q.shape[-1], v.shape[-1]) is not None)


# ------------------------------------------------ cluster-parallel path ---

def _cluster_prologue(mesh):
    """(dp, tp, dp spec entry, tp spec entry) of a cluster call; an
    absent axis acts as size 1, so pure-DP and pure-TP meshes work."""
    return (shrules.cluster_axis_size(mesh, shrules.DP_AXIS),
            shrules.cluster_axis_size(mesh, shrules.TP_AXIS),
            shrules.axis_entry(mesh, shrules.DP_AXIS),
            shrules.axis_entry(mesh, shrules.TP_AXIS))


def _pad_rows(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])


def _run_on_mesh(mesh, out_spec, out_shape, placed, local):
    """Run ``local(pos, *shards at pos)`` once per distinct (output block,
    device) and assemble the outputs; ``placed`` are `Sharded` inputs."""
    positions = pmesh.unique_positions(mesh, out_spec, len(out_shape))
    outs = pmesh.run_per_shard(
        mesh, local, [[a.shards[p] for a in placed] for p in positions],
        positions)
    return pmesh.assemble(mesh, out_spec, out_shape,
                          dict(zip(positions, outs)))


def qdot_sharded(params, x_hat: torch.Tensor, *, mesh, epilogue: str = "int",
                 scale=1.0, pipeline: Optional[str] = None) -> torch.Tensor:
    """`qdot` on a mesh (module docstring, cluster path). A presharded
    artifact (`parallel.sharding.shard_packed_linear`) is taken as it is;
    the result is one global tensor on ``x_hat``'s device."""
    dp, tp, dpe, tpe = _cluster_prologue(mesh)
    wspecs = shrules.packed_linear_specs(params, mesh)
    lead = x_hat.shape[:-1]
    x2 = x_hat.reshape(-1, x_hat.shape[-1])
    m = x2.shape[0]
    x2 = _pad_rows(x2, dp)
    n = params.w_packed.shape[1]
    k_pad = params.w_packed.shape[0] * packing.pack_factor(params.w_bits)
    m_loc, n_loc = x2.shape[0] // dp, n // tp
    backend = device_backend(mesh.flat[0])
    launch, pipeline = _resolve_call("qdot", (m_loc, k_pad, n_loc),
                                     params.a_bits, params.w_bits, backend,
                                     pipeline)
    per_n = not isinstance(scale, (int, float)) and \
        torch.as_tensor(scale).dim() == 1
    put = lambda a, spec: device_put(a, NamedSharding(mesh, spec))
    placed = [put(x2, P(dpe, None)),
              *(put(getattr(params, k), wspecs[k])
                for k in ("w_packed", "kappa", "lam", "m"))]
    if per_n:
        placed.append(put(torch.as_tensor(scale, device=x_hat.device),
                          P(tpe)))

    def local(pos, xs, wp, kappa, lam, mm, s=scale):
        p_loc = dataclasses.replace(params, w_packed=wp, kappa=kappa,
                                    lam=lam, m=mm)
        xp = packing.pack(packing.pad_to_chunk(xs, axis=-1), params.a_bits,
                          axis=-1)
        return qdot_run(p_loc, xp, epilogue=epilogue, scale=s,
                        pipeline=pipeline, launch=launch)

    out = _run_counted(
        "qdot", (x2.shape[0], k_pad, n), params.a_bits, params.w_bits,
        backend, pipeline,
        lambda: gather(_run_on_mesh(mesh, P(dpe, tpe), (x2.shape[0], n),
                                    placed, local), x_hat.device))
    return out[:m].reshape(*lead, n)


def qconv_sharded(params, x_hat: torch.Tensor, *, mesh, epilogue: str = "int",
                  scale=1.0, pipeline: Optional[str] = None) -> torch.Tensor:
    """`qconv` on a mesh: images data-parallel over the batch (padded to
    a ``dp`` multiple, sliced back), both packed weight layouts and the
    epilogue vectors tensor-parallel over Cout (module docstring)."""
    _check_ungrouped(params)
    dp, tp, dpe, tpe = _cluster_prologue(mesh)
    wspecs = shrules.packed_conv_specs(params, mesh)
    nb = x_hat.shape[0]
    x = _pad_rows(x_hat, dp)
    g = params.gemm
    cout_loc = params.cout // tp
    geom = (params.fh, params.fw, params.stride, params.padding)
    backend = device_backend(mesh.flat[0])
    _, pipeline = _resolve_call(
        "qconv", (x.shape[0] // dp, *x.shape[1:], *geom, cout_loc,
                  params.groups), g.a_bits, g.w_bits, backend, pipeline)
    per_n = not isinstance(scale, (int, float)) and \
        torch.as_tensor(scale).dim() == 1
    put = lambda a, spec: device_put(a, NamedSharding(mesh, spec))
    gs = wspecs["gemm"]
    placed = [put(x, P(dpe, None, None, None)),
              put(params.w_packed_fused, wspecs["w_packed_fused"]),
              *(put(getattr(g, k), gs[k])
                for k in ("w_packed", "kappa", "lam", "m"))]
    if per_n:
        placed.append(put(torch.as_tensor(scale, device=x_hat.device),
                          P(tpe)))

    def local(pos, xs, wpf, wp, kappa, lam, mm, s=scale):
        g_loc = dataclasses.replace(g, w_packed=wp, kappa=kappa, lam=lam,
                                    m=mm)
        p_loc = dataclasses.replace(params, gemm=g_loc, w_packed_fused=wpf,
                                    cout=cout_loc)
        return qconv_run(p_loc, xs, epilogue=epilogue, scale=s,
                         pipeline=pipeline)

    ho = (x.shape[1] + 2 * params.padding - params.fh) // params.stride + 1
    wo = (x.shape[2] + 2 * params.padding - params.fw) // params.stride + 1
    out_shape = (x.shape[0], ho, wo, params.cout)
    out = _run_counted(
        "qconv", (*x.shape, *geom, params.cout, params.groups), g.a_bits,
        g.w_bits, backend, pipeline,
        lambda: gather(_run_on_mesh(mesh, P(dpe, None, None, tpe),
                                    out_shape, placed, local),
                       x_hat.device))
    return out[:nb]
