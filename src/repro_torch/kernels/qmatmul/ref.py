"""numpy oracle for the packed sub-byte GEMM (eq. 2-4, int64 requant).

Independent of the torch packing code: its own unpack, int32
accumulation semantics, and a requant product wider than the kernels'.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import packing


def unpack_np(p, bits: int, signed: bool, axis: int = -1) -> np.ndarray:
    """numpy chunk-planar unpack."""
    p = np.asarray(p, dtype=np.int8)
    if bits == 8:
        return p
    pf = 8 // bits
    p = np.moveaxis(p, axis, -1)
    *lead, kp = p.shape
    sub = packing.CHUNK // pf
    chunks = p.reshape(*lead, kp // sub, sub).astype(np.uint8)
    planes = []
    for pl in range(pf):
        field = (chunks >> (bits * pl)) & ((1 << bits) - 1)
        if signed:
            sign = 1 << (bits - 1)
            field = (field.astype(np.int16) ^ sign) - sign
        planes.append(field.astype(np.int8))
    out = np.stack(planes, axis=-2).reshape(*lead, kp * pf)
    return np.moveaxis(out, -1, axis)


def qmatmul_ref(x_packed, w_packed, kappa, lam, m_mul, *,
                a_bits: int, a_signed: bool, w_bits: int,
                d: int, out_bits: int, epilogue: str = "int",
                scale: float = 1.0) -> np.ndarray:
    x = unpack_np(x_packed, a_bits, a_signed, axis=-1).astype(np.int32)
    w = unpack_np(w_packed, w_bits, True, axis=0).astype(np.int32)
    with np.errstate(over="ignore"):
        acc = (x @ w).astype(np.int32)
        if epilogue == "raw":
            return acc
        if epilogue == "dequant":
            return acc.astype(np.float32) * np.asarray(scale, np.float32)
        kappa = np.asarray(kappa, dtype=np.int32).reshape(1, -1)
        lam = np.asarray(lam, dtype=np.int32).reshape(1, -1)
        m = np.asarray(m_mul, dtype=np.int64).reshape(1, -1)
        phi_p = (acc * kappa + lam).astype(np.int32)
        y = (m * phi_p.astype(np.int64)) >> d
        hi = packing.int_range(out_bits, False)[1]
        return np.clip(y, 0, hi).astype(np.int8)


def segment_view_np(w_flat, segmap, index: int, k: int) -> np.ndarray:
    """numpy view of run ``index`` of a panel-major segmented buffer as
    its uniform (K_pad/pf, run_len) container."""
    w_flat = np.asarray(w_flat, dtype=np.int8)
    s, e, b = segmap.runs[index]
    rows = packing.padded_size(k) // (8 // b)
    pos = segmap.seg_offsets(k)[index]
    panels = []
    for p0 in range(s, e, packing.CHUNK):
        pw = min(packing.CHUNK, e - p0)
        panels.append(w_flat[pos:pos + rows * pw].reshape(rows, pw))
        pos += rows * pw
    return np.concatenate(panels, axis=1)


def qmatmul_segmented_ref(x_packed, w_flat, segmap, kappa, lam, m_mul, *,
                          k_logical: int, a_bits: int, a_signed: bool,
                          d: int, out_bits: int, epilogue: str = "int",
                          scale: float = 1.0) -> np.ndarray:
    """Composition oracle: each run through the uniform `qmatmul_ref`
    with its own width and epilogue slice, concatenated along N."""
    outs = []
    for i, (s, e, b) in enumerate(segmap.runs):
        sc = scale if np.ndim(scale) == 0 else np.asarray(scale)[s:e]
        outs.append(qmatmul_ref(
            x_packed, segment_view_np(w_flat, segmap, i, k_logical),
            np.asarray(kappa)[s:e], np.asarray(lam)[s:e],
            np.asarray(m_mul)[s:e], a_bits=a_bits, a_signed=a_signed,
            w_bits=b, d=d, out_bits=out_bits, epilogue=epilogue, scale=sc))
    return np.concatenate(outs, axis=-1)
