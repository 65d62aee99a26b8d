"""Sub-byte pack/unpack — the storage layer, byte-identical to ``repro``.

Chunk-planar packing along the reduction (K) axis: within each chunk of
``CHUNK = 128`` logical elements, packed byte ``j`` of the chunk holds
logical elements ``j, j+64`` (4-bit) or ``j, j+32, j+64, j+96`` (2-bit) in
its low→high bit-fields. Plane ``p`` of chunk ``c`` therefore holds logical
elements ``c*CHUNK + p*(CHUNK/pf) + j``. The CUDA kernels unpack both
operands into that logical order in shared memory, so operands of unequal
widths pair up without the reference's plane sub-splitting.

8-bit operands are stored as-is (one int8 per element). Unsigned 8-bit
values are capped at 127: the containers are int8 and the reference keeps
that grid, so the port keeps it too.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 128

# (signed lo, signed hi, unsigned lo, unsigned hi); unsigned 8-bit caps at
# 127 because the containers are int8 (the reference's grid).
_INT_INFO = {
    8: (-128, 127, 0, 127),
    4: (-8, 7, 0, 15),
    2: (-2, 1, 0, 3),
}


def pack_factor(bits: int) -> int:
    if bits not in (8, 4, 2):
        raise ValueError(f"unsupported bitwidth {bits}")
    return 8 // bits


def int_range(bits: int, signed: bool) -> tuple[int, int]:
    lo_s, hi_s, lo_u, hi_u = _INT_INFO[bits]
    return (lo_s, hi_s) if signed else (lo_u, hi_u)


def check_range(x: torch.Tensor, bits: int, signed: bool = True):
    """Raise if any value of ``x`` is off the ``bits``-wide grid.

    `pack` keeps only the low ``bits`` bits, so an out-of-range value would
    silently become a different in-range value in the artifact.
    """
    lo, hi = int_range(bits, signed)
    if x.numel() == 0:
        return
    saw_lo, saw_hi = int(x.min()), int(x.max())
    if saw_lo < lo or saw_hi > hi:
        raise ValueError(
            f"pack: values outside the {'signed' if signed else 'unsigned'} "
            f"{bits}-bit range [{lo}, {hi}] (saw min={saw_lo}, "
            f"max={saw_hi}); packing would silently truncate — "
            "quantize/clip first")


def _to_int8(v: torch.Tensor) -> torch.Tensor:
    """int32 byte patterns in [0, 256) -> int8 with two's-complement wrap."""
    return torch.where(v > 127, v - 256, v).to(torch.int8)


def pack(x: torch.Tensor, bits: int, axis: int = -1, *,
         assert_range: bool = False, signed: bool = True) -> torch.Tensor:
    """Pack sub-byte integer values (int8 tensor) into int8 containers,
    chunk-planar along ``axis`` (a CHUNK multiple)."""
    if assert_range:
        check_range(x, bits, signed)
    if bits == 8:
        return x.to(torch.int8)
    pf = pack_factor(bits)
    x = torch.movedim(x, axis, -1)
    *lead, k = x.shape
    if k % CHUNK:
        raise ValueError(
            f"packing axis ({k}) must be a multiple of CHUNK={CHUNK}")
    sub = CHUNK // pf
    planes = x.reshape(*lead, k // CHUNK, pf, sub).to(torch.int32)
    mask = (1 << bits) - 1
    out = torch.zeros((*lead, k // CHUNK, sub), dtype=torch.int32,
                      device=x.device)
    for p in range(pf):
        out = out | ((planes[..., p, :] & mask) << (bits * p))
    out = _to_int8(out.reshape(*lead, k // pf))
    return torch.movedim(out, -1, axis).contiguous()


def _extract_field(container: torch.Tensor, bits: int, plane: int,
                   signed: bool) -> torch.Tensor:
    """Bit-field ``plane`` of int8 containers, sign- or zero-extended."""
    byte = container.to(torch.int32) & 0xFF
    field = (byte >> (bits * plane)) & ((1 << bits) - 1)
    if signed:
        field = torch.where(field >= (1 << (bits - 1)),
                            field - (1 << bits), field)
    return field.to(torch.int8)


def unpack_planes(p_block: torch.Tensor, bits: int, signed: bool):
    """Split a packed block (packed K on the leading axis) into its ``pf``
    planes: plane ``p`` holds logical elements ``chunk*CHUNK + p*sub + j``.
    """
    if bits == 8:
        return [p_block.to(torch.int8)]
    return [_extract_field(p_block, bits, pl, signed)
            for pl in range(pack_factor(bits))]


def unpack(p: torch.Tensor, bits: int, signed: bool,
           axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack`; int8 values in the sub-byte range."""
    if bits == 8:
        return p.to(torch.int8)
    pf = pack_factor(bits)
    p = torch.movedim(p, axis, -1)
    *lead, kp = p.shape
    sub = CHUNK // pf
    if kp % sub:
        raise ValueError(f"packed axis ({kp}) not a multiple of {sub}")
    chunks = p.reshape(*lead, kp // sub, sub)
    out = torch.stack(unpack_planes(chunks, bits, signed), dim=-2)
    out = out.reshape(*lead, kp * pf)
    return torch.movedim(out, -1, axis).contiguous()


def planar_perm(k: int, bits: int) -> np.ndarray:
    """Permutation mapping planar-order position -> logical K index."""
    if bits == 8:
        return np.arange(k)
    pf = pack_factor(bits)
    idx = np.arange(k).reshape(k // CHUNK, pf, CHUNK // pf)
    return idx.reshape(-1)


def pad_to_chunk(x: torch.Tensor, axis: int = -1,
                 value: int = 0) -> torch.Tensor:
    """Pad ``axis`` up to a CHUNK multiple (zero padding == zero MACs)."""
    pad = (-x.shape[axis]) % CHUNK
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def padded_size(k: int) -> int:
    return k + ((-k) % CHUNK)
