"""Packed sub-byte integer GEMMs: the CUDA kernels and their plain
versions.

`qmatmul_packed` (uniform weight width) and `qmatmul_segmented` (a
panel-major `SegmentMap` buffer, one width per output-channel run)
dispatch on the tensors' device: CUDA tensors launch the Hopper kernels
(``csrc/qmatmul.cu``, ``csrc/qmatmul_segmented.cu``; STAGES=1 for
pipeline 'off', STAGES=2 for 'double_buffer'); CPU tensors run the plain
versions `qmatmul_packed_torch` / `qmatmul_segmented_torch`, the same
unpack -> contract -> epilogue in torch. There is no fallback from one to
the other: a CUDA call that cannot launch raises.

Both kernels contract on the tensor cores in blocks of 128 rows
(``csrc/mma_s8.cuh``), one CHUNK of K per stage, up to the real K
(``k_logical``) rounded up to 32. The launch is planned here, where the
CPU tests reach it: the uniform GEMM's column tile is N rounded up to a
wgmma width (`gemm_tile_n`); K is split across blocks where the output
tiles do not fill the card (`k_splits`); the register budget is chosen
per grid (`gemm_launch_plan`). A launch measured by `kernels/tune.py`
(``launch=``, one of `gemm_launches`) replaces the planned one.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import (EPILOGUES, PIPELINE_STAGES,
                                        apply_epilogue, check_pipeline,
                                        epilogue_dtype, int_matmul)
from repro_torch.obs import accounting

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "qmatmul", "qmatmul.cu", "qmatmul_launch",
    [_P, _P, _P, _P, _P, _P, ctypes.c_float, _P] + [_I] * 15 + [_P])
SEGMENTED_KERNEL = CudaKernel(
    "qmatmul_segmented", "qmatmul_segmented.cu", "qmatmul_segmented_launch",
    [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, ctypes.c_float, _P]
    + [_I] * 12 + [_P])


def _packed_shape(x, w_packed, a_bits: int, w_bits: int,
                  k_logical: Optional[int]):
    """(M, K_pad, N, k_logical) of a uniform packed GEMM, after checking
    the shapes the kernel and its plain version both assume."""
    pf_a, pf_w = packing.pack_factor(a_bits), packing.pack_factor(w_bits)
    m, k_pad = x.shape[0], x.shape[1] * pf_a
    if w_packed.shape[0] * pf_w != k_pad or k_pad % packing.CHUNK:
        raise ValueError(
            f"x {tuple(x.shape)} (A{a_bits}) and w {tuple(w_packed.shape)} "
            f"(W{w_bits}) disagree on K, or K={k_pad} is not a CHUNK "
            "multiple")
    k_logical = k_pad if k_logical is None else int(k_logical)
    if not 0 < k_logical <= k_pad:
        raise ValueError(f"k_logical={k_logical} outside (0, {k_pad}]")
    return m, k_pad, w_packed.shape[1], k_logical


def qmatmul_packed_torch(x, w_packed, kappa, lam, m_mul, *, a_bits: int,
                         a_signed: bool, w_bits: int, d: int, out_bits: int,
                         epilogue: str = "int", scale=1.0,
                         k_logical: Optional[int] = None,
                         out_dtype=None) -> torch.Tensor:
    """Plain version: x (M, K_pad/pf_a) @ w (K_pad/pf_w, N), both packed
    along K, summed over the first ``k_logical`` values of K (default: all
    of K_pad; the artifact's padding is zero, so both give the same
    result), then the epilogue. Runs on whatever device the tensors are
    on."""
    _, _, _, k = _packed_shape(x, w_packed, a_bits, w_bits, k_logical)
    acc = int_matmul(packing.unpack(x, a_bits, a_signed, axis=-1)[:, :k],
                     packing.unpack(w_packed, w_bits, True, axis=0)[:k])
    return apply_epilogue(acc, kappa, lam, m_mul, d=d, out_bits=out_bits,
                          epilogue=epilogue, scale=scale,
                          out_dtype=out_dtype)


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{t.device}; CPU tensors take the plain version")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned for cp.async")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def epilogue_launch_args(kappa, lam, m_mul, *, n: int, d: int,
                         out_bits: int, epilogue: str, scale, device):
    """Checked epilogue operands of a kernel launch: (kappa, lam, m,
    per-channel scale tensor or None, scalar scale, d, hi, code). Only
    'int' reads kappa, lam and m; the others take None for them."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; expected "
                         f"{EPILOGUES}")
    for t, name in ((kappa, "kappa"), (lam, "lam"), (m_mul, "m")):
        if t is None:
            if epilogue == "int":
                raise ValueError(f"epilogue 'int' needs {name}")
            continue
        _check(t, name, torch.int32, device, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} channels, "
                             f"expected {n}")
    if epilogue == "int" and not 16 <= d <= 31:
        raise ValueError(f"requant shift d={d} outside [16, 31]")
    scale_vec, scale_f = None, 1.0
    if not isinstance(scale, (int, float)):
        scale = torch.as_tensor(scale)
    if isinstance(scale, torch.Tensor) and scale.dim() == 1:
        scale_vec = scale.to(device=device, dtype=torch.float32).contiguous()
        if scale_vec.shape[0] != n:
            raise ValueError(f"scale has {scale_vec.shape[0]} channels, "
                             f"expected {n}")
    else:
        scale_f = float(scale)
    hi = packing.int_range(out_bits, False)[1]
    return (kappa, lam, m_mul, scale_vec, scale_f, d, hi,
            EPILOGUES.index(epilogue))


def qmatmul_packed_cuda(x, w_packed, kappa, lam, m_mul, *, a_bits: int,
                        a_signed: bool, w_bits: int, d: int, out_bits: int,
                        epilogue: str = "int", scale=1.0,
                        pipeline: str = "off",
                        k_logical: Optional[int] = None,
                        launch: Optional[dict] = None,
                        out_dtype=None) -> torch.Tensor:
    """Launch the Hopper kernel on CUDA tensors as `gemm_launch_plan`
    plans it, or with ``launch`` ({"splits", "min_blocks"}, a tuned
    launch, which `gemm_launch_plan` refuses unless it fits the shape);
    raises on anything it does not take."""
    plan = None
    if launch is not None:
        m, _, n, k = _packed_shape(x, w_packed, a_bits, w_bits, k_logical)
        plan = gemm_launch_plan(m, n, k, a_bits, sm_count(x.device),
                                splits=launch["splits"],
                                min_blocks=launch["min_blocks"])
    return _launch_packed(x, w_packed, kappa, lam, m_mul, plan,
                          a_bits=a_bits, a_signed=a_signed, w_bits=w_bits,
                          d=d, out_bits=out_bits, epilogue=epilogue,
                          scale=scale, pipeline=pipeline,
                          k_logical=k_logical, out_dtype=out_dtype)


def _launch_packed(x, w_packed, kappa, lam, m_mul,
                   plan: Optional["GemmLaunch"], *, a_bits: int,
                   a_signed: bool, w_bits: int, d: int, out_bits: int,
                   epilogue: str, scale, pipeline: str,
                   k_logical: Optional[int], out_dtype=None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`qmatmul_packed_cuda` at a given launch ``plan`` (None: the planned
    one), into ``out`` (M, N) when given (a contiguous view, such as a
    run of another output's rows). Tests and measurements pass the
    launches the plan did not choose; the result does not depend on the
    plan."""
    stages = PIPELINE_STAGES[check_pipeline(pipeline)]
    dev = x.device
    _check(x, "x", torch.int8, dev, 2)
    _check(w_packed, "w_packed", torch.int8, dev, 2)
    m, k_pad, n, k_logical = _packed_shape(x, w_packed, a_bits, w_bits,
                                           k_logical)
    kappa, lam, m_mul, svec, sf, d, hi, code = epilogue_launch_args(
        kappa, lam, m_mul, n=n, d=d, out_bits=out_bits, epilogue=epilogue,
        scale=scale, device=dev)
    dtype = epilogue_dtype(epilogue, out_dtype)
    if out is None:
        out = torch.empty((m, n), dtype=dtype, device=dev)
    else:
        _check(out, "out", dtype, dev, 2)
        if tuple(out.shape) != (m, n):
            raise ValueError(f"out {tuple(out.shape)}, expected {(m, n)}")
    if m == 0 or n == 0:
        return out
    sms = sm_count(dev)
    if plan is None:
        plan = gemm_launch_plan(m, n, k_logical, a_bits, sms)
    elif plan != gemm_launch_plan(m, n, k_logical, a_bits, sms,
                                  splits=plan.splits,
                                  min_blocks=plan.min_blocks):
        raise ValueError(f"{plan} is not a launch of the ({m}, {k_logical},"
                         f" {n}) A{a_bits} GEMM")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(
            stages, x.data_ptr(), w_packed.data_ptr(), _ptr(kappa),
            _ptr(lam), _ptr(m_mul), _ptr(svec), sf, out.data_ptr(),
            plan.splits, plan.nt, plan.min_blocks, m, n, k_pad, k_logical,
            a_bits, w_bits, int(a_signed), d, hi, code,
            int(dtype == torch.float32), stages, stream)
    return out


def qmatmul_packed(x, w_packed, kappa, lam, m_mul, *, a_bits: int,
                   a_signed: bool, w_bits: int, d: int, out_bits: int,
                   epilogue: str = "int", scale=1.0, pipeline: str = "off",
                   k_logical: Optional[int] = None,
                   launch: Optional[dict] = None,
                   out_dtype=None) -> torch.Tensor:
    """Packed GEMM: x (M, K_pad/pf_a) @ w (K_pad/pf_w, N) over the first
    ``k_logical`` values of K, with the fused epilogue ('dequant' writes
    ``out_dtype``: bfloat16 by default, or float32; 'int' alone reads
    kappa, lam and m, which may be None otherwise). CUDA tensors launch
    the kernel (at ``launch`` when given, else as planned); CPU tensors
    run the plain version, which has no launch to choose."""
    check_pipeline(pipeline)
    kw = dict(a_bits=a_bits, a_signed=a_signed, w_bits=w_bits, d=d,
              out_bits=out_bits, epilogue=epilogue, scale=scale,
              k_logical=k_logical, out_dtype=out_dtype)
    if x.is_cuda:
        return qmatmul_packed_cuda(x, w_packed, kappa, lam, m_mul,
                                   pipeline=pipeline, launch=launch, **kw)
    macs = (x.shape[0] * x.shape[1] * packing.pack_factor(a_bits)
            * w_packed.shape[1])
    return accounting.packed(
        "qmatmul", macs, (x, w_packed, kappa, lam, m_mul, scale),
        lambda: qmatmul_packed_torch(x, w_packed, kappa, lam, m_mul, **kw))


def qmatmul_grouped(x, w_packed, scale, counts, *, a_bits: int,
                    w_bits: int, pipeline: str = "off",
                    k_logical: Optional[int] = None,
                    out_dtype=None) -> torch.Tensor:
    """Packed GEMMs of row groups with the 'dequant' epilogue: group e,
    ``counts[e]`` rows of x (R, K_pad/pf_a) in order (signed activations,
    packed along K), against ``w_packed[e]`` (E, K_pad/pf_w, N) with
    ``scale[e]`` (E, N) float32 per channel, into its rows of one (R, N)
    output; a group of no rows runs nothing. Each group is
    `qmatmul_packed` on its rows: CUDA tensors launch the kernel at its
    planned launch, writing the group's rows in place; CPU tensors run
    the plain version."""
    check_pipeline(pipeline)
    n_groups, _, n = w_packed.shape
    if len(counts) != n_groups or sum(counts) != x.shape[0] or \
            tuple(scale.shape) != (n_groups, n):
        raise ValueError(f"{len(counts)} groups of {sum(counts)} rows for x "
                         f"{tuple(x.shape)}, w {tuple(w_packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    dtype = epilogue_dtype("dequant", out_dtype)
    out = torch.empty((x.shape[0], n), dtype=dtype, device=x.device)
    kw = dict(a_bits=a_bits, a_signed=True, w_bits=w_bits, d=0,
              out_bits=8, epilogue="dequant", pipeline=pipeline,
              k_logical=k_logical, out_dtype=dtype)
    start = 0
    for e, c in enumerate(counts):
        if c:
            rows = slice(start, start + c)
            if x.is_cuda:
                _launch_packed(x[rows], w_packed[e], None, None, None, None,
                               scale=scale[e], out=out[rows], **kw)
            else:
                out[rows] = qmatmul_packed(x[rows], w_packed[e], None, None,
                                           None, scale=scale[e], **kw)
        start += c
    return out


# ------------------------------------------------------ launch planning ---

# Rows of one block of either GEMM kernel (csrc/mma_s8.cuh); K advances
# one CHUNK per stage.
TILE_M = 128


def gemm_tile_n(n: int) -> int:
    """The uniform GEMM's column tile: N rounded up to 16, 32, 64 or 128
    (wider N takes several tiles). wgmma's n; the mixed-operand GEMM
    takes one CHUNK-wide panel."""
    return min(128, max(16, 1 << (n - 1).bit_length()))


# At most this many blocks share one tile's K: one portable thread block
# cluster, whose blocks add up their partial sums through distributed
# shared memory (csrc/mma_s8.cuh::cluster_split_reduce).
MAX_SPLITS = 8


def k_splits(tiles: int, stages: int, sms: int) -> int:
    """How many blocks of a GEMM kernel share one output tile's K stages:
    1 when the tiles already fill ``sms`` SMs, else enough to fill them,
    at most `MAX_SPLITS`, with at least one stage per block. Integer
    partial sums add exactly in any order, so the split never changes a
    result."""
    if tiles >= sms or stages <= 1:
        return 1
    per = -(-stages // min(stages, -(-sms // tiles), MAX_SPLITS))
    return -(-stages // per)


@dataclasses.dataclass(frozen=True)
class GemmLaunch:
    """One launch of the uniform GEMM kernel: column tile, output tiles,
    K stages, blocks per tile along K, register budget (blocks per SM)."""
    nt: int
    tiles: int
    stages: int
    splits: int
    min_blocks: int


def gemm_launch_plan(m: int, n: int, k_logical: int, a_bits: int, sms: int,
                     *, splits: Optional[int] = None,
                     min_blocks: Optional[int] = None) -> GemmLaunch:
    """The uniform GEMM's launch: 128 x `gemm_tile_n(n)` output tiles, K in
    CHUNK stages split by `k_splits`, and registers for two resident
    blocks per SM only where the grid is wider than the card at A8 and the
    128-wide tile (the accumulators alone would hold one block per SM;
    sub-byte activations need an activation ring, which leaves shared
    memory for one). ``splits`` / ``min_blocks`` override the choice."""
    nt = gemm_tile_n(n)
    tiles = -(-m // TILE_M) * -(-n // nt)
    stages = -(-k_logical // packing.CHUNK)
    if splits is None:
        splits = k_splits(tiles, stages, sms)
    elif not 1 <= splits <= min(stages, MAX_SPLITS):
        raise ValueError(f"splits={splits} outside [1, {MAX_SPLITS}] or "
                         f"above the {stages} stages")
    if min_blocks is None:
        min_blocks = 2 if a_bits == 8 and nt == 128 and tiles > sms else 1
    elif min_blocks not in (1, 2) or (min_blocks == 2 and
                                      (a_bits != 8 or nt != 128)):
        raise ValueError(f"min_blocks={min_blocks}: the kernel has 1, and "
                         "2 at A8 with the 128-wide tile")
    return GemmLaunch(nt, tiles, stages, splits, min_blocks)


def gemm_launches(m: int, n: int, k_logical: int, a_bits: int,
                  sms: int) -> list:
    """Every launch `gemm_launch_plan` accepts for the shape, the planned
    one first: each K split from 1 to min(stages, `MAX_SPLITS`) at each
    register budget the tile allows. Every one gives the same result."""
    plan = gemm_launch_plan(m, n, k_logical, a_bits, sms)
    budgets = (1, 2) if a_bits == 8 and plan.nt == 128 else (1,)
    others = [gemm_launch_plan(m, n, k_logical, a_bits, sms, splits=s,
                               min_blocks=b)
              for s in range(1, min(plan.stages, MAX_SPLITS) + 1)
              for b in budgets]
    return [plan] + [p for p in others if p != plan]


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ------------------------------------------------ segmented (mixed) GEMM ---

def _check_segmented(x, w_flat, segmap, k_logical: int, a_bits: int):
    """(M, K_pad, N) of a mixed-operand call, after checking the shapes
    the kernel and its plain version both assume."""
    pf_a = packing.pack_factor(a_bits)
    m, k_pad = x.shape[0], x.shape[1] * pf_a
    if k_pad != packing.padded_size(k_logical):
        raise ValueError(f"x {tuple(x.shape)} (A{a_bits}) holds K={k_pad}; "
                         f"expected padded_size({k_logical})")
    n = segmap.n
    if n % packing.CHUNK:
        raise ValueError(f"N={n} is not a CHUNK multiple; pad the container "
                         "first (packing.pad_segmented)")
    if w_flat.dim() != 1 or w_flat.shape[0] != segmap.packed_bytes(
            k_logical):
        raise ValueError(
            f"w_flat {tuple(w_flat.shape)} is not a flat buffer of "
            f"{segmap.packed_bytes(k_logical)} bytes for {segmap.runs}")
    return m, k_pad, n


def qmatmul_segmented_torch(x, w_flat, segmap, kappa, lam, m_mul, *,
                            k_logical: int, a_bits: int, a_signed: bool,
                            d: int, out_bits: int, epilogue: str = "int",
                            scale=1.0, out_dtype=None) -> torch.Tensor:
    """Plain version: x (M, K_pad/pf_a) against the flat panel-major
    buffer, read panel by panel through `SegmentMap.tile_table`'s
    (width code, byte offset) descriptors as the kernel reads it, then
    the epilogue. N must be a CHUNK multiple (`pad_segmented`)."""
    m, k_pad, n = _check_segmented(x, w_flat, segmap, k_logical, a_bits)
    codes, offs = segmap.tile_table(k_logical)
    widths = segmap.widths()
    xu = packing.unpack(x, a_bits, a_signed, axis=-1)
    acc = torch.empty((m, n), dtype=torch.int32, device=x.device)
    for j, (code, off) in enumerate(zip(codes.tolist(), offs.tolist())):
        bits = widths[code]
        rows = k_pad // packing.pack_factor(bits)
        panel = w_flat[off:off + rows * packing.CHUNK].reshape(
            rows, packing.CHUNK)
        acc[:, j * packing.CHUNK:(j + 1) * packing.CHUNK] = int_matmul(
            xu, packing.unpack(panel, bits, True, axis=0))
    return apply_epilogue(acc, kappa, lam, m_mul, d=d, out_bits=out_bits,
                          epilogue=epilogue, scale=scale,
                          out_dtype=out_dtype)


@functools.lru_cache(maxsize=64)
def segment_descriptors(segmap, k_logical: int, device: torch.device):
    """The kernel's per-panel (codes, offsets) int32 tensors on
    ``device``, built once per (segmap, K, device)."""
    total = segmap.packed_bytes(k_logical)
    if total >= 2 ** 31:
        raise ValueError(f"segmented buffer of {total} bytes: the kernel's "
                         "int32 byte offsets need < 2^31")
    codes, offs = segmap.tile_table(k_logical)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(offs).to(device))


def qmatmul_segmented_cuda(x, w_flat, segmap, kappa, lam, m_mul, *,
                           k_logical: int, a_bits: int, a_signed: bool,
                           d: int, out_bits: int, epilogue: str = "int",
                           scale=1.0, pipeline: str = "off",
                           out_dtype=None) -> torch.Tensor:
    """Launch the mixed-operand Hopper kernel on CUDA tensors (raises on
    anything it does not take)."""
    stages = PIPELINE_STAGES[check_pipeline(pipeline)]
    dev = x.device
    _check(x, "x", torch.int8, dev, 2)
    _check(w_flat, "w_flat", torch.int8, dev, 1)
    m, k_pad, n = _check_segmented(x, w_flat, segmap, k_logical, a_bits)
    kappa, lam, m_mul, svec, sf, d, hi, code = epilogue_launch_args(
        kappa, lam, m_mul, n=n, d=d, out_bits=out_bits, epilogue=epilogue,
        scale=scale, device=dev)
    codes, offs = segment_descriptors(segmap, k_logical, dev)
    widths = segmap.widths()
    widths = widths + (widths[0],) * (3 - len(widths))
    dtype = epilogue_dtype(epilogue, out_dtype)
    out = torch.empty((m, n), dtype=dtype, device=dev)
    if m == 0:
        return out
    # one block per 128 rows x one 128-wide panel, K in stages of 128
    tiles = -(-m // TILE_M) * (n // packing.CHUNK)
    splits = k_splits(tiles, -(-k_logical // packing.CHUNK), sm_count(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        SEGMENTED_KERNEL.launch(
            stages, x.data_ptr(), w_flat.data_ptr(), codes.data_ptr(),
            offs.data_ptr(), *widths, _ptr(kappa), _ptr(lam), _ptr(m_mul),
            _ptr(svec), sf, out.data_ptr(), splits, m, n, k_pad, k_logical,
            a_bits, int(a_signed), d, hi, code,
            int(dtype == torch.float32), stages, stream)
    return out


def qmatmul_segmented(x, w_flat, segmap, kappa, lam, m_mul, *,
                      k_logical: int, a_bits: int, a_signed: bool, d: int,
                      out_bits: int, epilogue: str = "int", scale=1.0,
                      pipeline: str = "off", out_dtype=None) -> torch.Tensor:
    """Mixed-operand packed GEMM: x (M, K_pad/pf_a) against a flat
    panel-major segmented buffer whose N is a CHUNK multiple, with the
    fused epilogue (``out_dtype`` as in `qmatmul_packed`). CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    check_pipeline(pipeline)
    kw = dict(k_logical=k_logical, a_bits=a_bits, a_signed=a_signed, d=d,
              out_bits=out_bits, epilogue=epilogue, scale=scale,
              out_dtype=out_dtype)
    if x.is_cuda:
        return qmatmul_segmented_cuda(x, w_flat, segmap, kappa, lam, m_mul,
                                      pipeline=pipeline, **kw)
    macs = (x.shape[0] * x.shape[1] * packing.pack_factor(a_bits)
            * segmap.n)
    return accounting.packed(
        "qmatmul_segmented", macs, (x, w_flat, kappa, lam, m_mul, scale),
        lambda: qmatmul_segmented_torch(x, w_flat, segmap, kappa, lam,
                                        m_mul, **kw))
