"""Shared pieces of the integer kernels and their plain versions.

Every kernel (packed GEMM, mixed-operand GEMM, fused conv) runs the
paper's per-tile pipeline:

    unpack(W, X) -> int8        (nibble/crumb operands, Table II)
    int8 x int8 -> int32        (sum-of-dot-product, eq. 2)
    kappa*acc + lambda          (integer batch-norm, eq. 3, int32 wrap)
    (m * .) >> d, clip          (QNT/ACT, eq. 4)  [epilogue='int']

`matmul_planes` and `apply_epilogue` are the plain torch versions of the
kernels' contraction and epilogue. The contraction is int32 `torch.mm` on
the CPU; CUDA has no integer `mm`, so there it runs in float64, which is
exact because every partial sum stays far below 2^53.

The CUDA kernels compile fixed tiles (``csrc/mma_s8.cuh``): 128 rows x
a wgmma-wide column tile (the packed GEMM's N rounded up to 16-128, one
CHUNK of K per stage; the mixed-operand GEMM's 128-wide panels; the
conv's Cout rounded up to 16-256 with at most 192 or 128 logical K per
stage), so there is no block to select: the reference's VMEM block
selectors have no counterpart, and each tile's shared memory is checked
against the sm_90 limit when it compiles.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.quantize import requantize_shift, wrap_int32

EPILOGUES = ("int", "dequant", "raw")
EPILOGUE_DTYPES = {"int": torch.int8, "dequant": torch.bfloat16,
                   "raw": torch.int32}
# what 'dequant' may write: bfloat16 (the default) or float32, as the
# reference's dense path asks for its input's dtype
DEQUANT_DTYPES = (torch.bfloat16, torch.float32)

# Software-pipeline modes — the Mac&Load knob. 'off' copies each K tile
# (qdot) or receptive-field tap (qconv) and then contracts it; with
# 'double_buffer' the copy of tile k+1 is in flight while tile k is
# contracted. The CUDA kernels take them as STAGES = 1 and STAGES = 2.
PIPELINE_MODES = ("off", "double_buffer")
PIPELINE_STAGES = {"off": 1, "double_buffer": 2}


def check_pipeline(mode: str) -> str:
    if mode not in PIPELINE_MODES:
        raise ValueError(
            f"unknown pipeline mode {mode!r}; expected one of "
            f"{PIPELINE_MODES}")
    return mode


def epilogue_dtype(epilogue: str, out_dtype=None) -> torch.dtype:
    """The output dtype of ``epilogue``: its own (`EPILOGUE_DTYPES`), or
    for 'dequant' an ``out_dtype`` of `DEQUANT_DTYPES`."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; expected "
                         f"{EPILOGUES}")
    if out_dtype is None:
        return EPILOGUE_DTYPES[epilogue]
    if epilogue != "dequant" or out_dtype not in DEQUANT_DTYPES:
        raise ValueError(f"out_dtype={out_dtype} with epilogue {epilogue!r}:"
                         f" only 'dequant' takes one, of {DEQUANT_DTYPES}")
    return out_dtype


def round_up(x: int, mult: int) -> int:
    return x + (-x) % mult


# --------------------------------------------------------- plain versions ---

def int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. Float64 holds
    every product and sum of int8 values exactly (|acc| < 2^53 for any K
    under 2^38), and BLAS runs it far faster than an integer matmul; on
    the CPU a product with M or N under 64 stays in int32, where the
    float64 copies of the operands cost more than they save."""
    if x.is_cuda or min(x.shape[0], w.shape[1]) >= 64:
        acc = torch.mm(x.to(torch.float64), w.to(torch.float64))
        return wrap_int32(acc.to(torch.int64)).to(torch.int32)
    return torch.mm(x.to(torch.int32), w.to(torch.int32))


def matmul_planes(x_block: torch.Tensor, w_block: torch.Tensor,
                  a_bits: int, a_signed: bool, w_bits: int) -> torch.Tensor:
    """Packed sub-byte dot product -> int32: x_block (M, K/pf_a) packed
    along K, w_block (K/pf_w, N) packed along K, both chunk-planar."""
    x = packing.unpack(x_block, a_bits, a_signed, axis=-1)
    w = packing.unpack(w_block, w_bits, True, axis=0)
    return int_matmul(x, w)


def apply_epilogue(acc: torch.Tensor, kappa, lam, m_mul, *, d: int,
                   out_bits: int, epilogue: str, scale,
                   out_dtype=None) -> torch.Tensor:
    """Epilogue on an int32 accumulator; per-channel vectors broadcast
    along the last (output-channel) axis (only 'int' reads kappa, lam
    and m, which may be None otherwise).

    'int':     eq. 3 with int32 wrap, then eq. 4 requant + clip -> int8.
    'dequant': float32 rescale (scalar or (N,) scale) -> bfloat16 (RNE),
               or the float32 product itself for ``out_dtype=float32``.
    'raw':     the int32 accumulators.
    """
    dtype = epilogue_dtype(epilogue, out_dtype)
    if epilogue == "int":
        phi = wrap_int32(acc.to(torch.int64) * kappa.to(torch.int64)
                         + lam.to(torch.int64))
        y = requantize_shift(phi, m_mul, d)
        hi = packing.int_range(out_bits, False)[1]
        return torch.clamp(y, 0, hi).to(torch.int8)
    if epilogue == "dequant":
        s = torch.as_tensor(scale, dtype=torch.float32, device=acc.device)
        return (acc.to(torch.float32) * s).to(dtype)
    return acc.to(torch.int32)
