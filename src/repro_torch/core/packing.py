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

Segmented containers (`SegmentMap`, `pack_segmented`) hold a weight
matrix whose output-channel runs have different widths, in one flat
panel-major buffer: each run's bytes are the uniform pack of its column
range, cut into CHUNK-wide column panels laid end to end.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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


def pack(x: torch.Tensor, bits: int, axis: int = -1, *,
         assert_range: bool = False, signed: bool = True) -> torch.Tensor:
    """Pack sub-byte integer values (int8 tensor) into contiguous int8
    containers, chunk-planar along ``axis`` (a CHUNK multiple)."""
    if assert_range:
        check_range(x, bits, signed)
    if bits == 8:
        return x.to(torch.int8).contiguous()
    pf = pack_factor(bits)
    ax = axis % x.dim()
    lead, k, trail = x.shape[:ax], x.shape[ax], x.shape[ax + 1:]
    if k % CHUNK:
        raise ValueError(
            f"packing axis ({k}) must be a multiple of CHUNK={CHUNK}")
    sub = CHUNK // pf
    # split the axis in place, (k // CHUNK, pf, sub), and OR the planes'
    # two's-complement low bits into bytes: no transpose, no int32 copy
    planes = x.to(torch.int8).reshape(*lead, k // CHUNK, pf, sub,
                                      *trail).view(torch.uint8)
    mask = (1 << bits) - 1
    out = planes.select(ax + 1, 0) & mask
    for p in range(1, pf):
        out |= (planes.select(ax + 1, p) & mask) << (bits * p)
    return out.view(torch.int8).reshape(*lead, k // pf, *trail).contiguous()


def _extract_field(container: torch.Tensor, bits: int, plane: int,
                   signed: bool) -> torch.Tensor:
    """Bit-field ``plane`` of int8 containers, sign- or zero-extended."""
    byte = container.view(torch.uint8)
    field = ((byte >> (bits * plane)) & ((1 << bits) - 1)).to(torch.int8)
    if signed:
        field = torch.where(field >= (1 << (bits - 1)),
                            field - (1 << bits), field)
    return field


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
    ax = axis % p.dim()
    lead, kp, trail = p.shape[:ax], p.shape[ax], p.shape[ax + 1:]
    sub = CHUNK // pf
    if kp % sub:
        raise ValueError(f"packed axis ({kp}) not a multiple of {sub}")
    # split the packed axis in place, (kp // sub, sub), and put the planes
    # between the two: no transpose of the container
    chunks = p.reshape(*lead, kp // sub, sub, *trail)
    out = torch.stack(unpack_planes(chunks, bits, signed), dim=ax + 1)
    return out.reshape(*lead, kp * pf, *trail)


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


# ------------------------------------------------- segmented containers ---

# Candidate container widths, widest first: the order `SegmentMap.widths`
# and the mixed-operand kernel's width codes use.
WIDTHS = (8, 4, 2)


@dataclasses.dataclass(frozen=True)
class SegmentMap:
    """Ordered ``(n_start, n_end, w_bits)`` runs over the output-feature
    axis (fine-grain mixed precision).

    Invariants, checked on construction: runs are non-empty and tile
    [0, N) contiguously in order; every *interior* boundary is a CHUNK
    multiple, so a CHUNK-wide N tile never straddles two widths (only the
    final run may end ragged); widths come from `WIDTHS`. Hashable, and
    JSON-serializable through `to_json_obj` / `from_json_obj`.
    """

    runs: Tuple[Tuple[int, int, int], ...]

    def __post_init__(self):
        runs = tuple((int(s), int(e), int(b)) for s, e, b in self.runs)
        object.__setattr__(self, "runs", runs)
        if not runs:
            raise ValueError("SegmentMap: empty run list")
        pos = 0
        for i, (s, e, b) in enumerate(runs):
            if b not in WIDTHS:
                raise ValueError(
                    f"SegmentMap: run {i} has unsupported width {b}; "
                    f"expected one of {WIDTHS}")
            if s != pos:
                kind = "overlaps" if s < pos else "leaves a gap after"
                raise ValueError(
                    f"SegmentMap: run {i} [{s}, {e}) {kind} the previous "
                    f"run (expected n_start={pos}); runs must tile N "
                    "contiguously in order")
            if e <= s:
                raise ValueError(
                    f"SegmentMap: run {i} [{s}, {e}) is empty or reversed")
            if i + 1 < len(runs) and e % CHUNK:
                raise ValueError(
                    f"SegmentMap: interior boundary {e} (run {i}) is not a "
                    f"multiple of CHUNK={CHUNK}; a kernel N-tile would "
                    "straddle two container widths (only the final run may "
                    "end ragged)")
            pos = e

    @staticmethod
    def uniform(n: int, bits: int) -> "SegmentMap":
        return SegmentMap(((0, int(n), int(bits)),))

    @property
    def n(self) -> int:
        return self.runs[-1][1]

    @property
    def is_uniform(self) -> bool:
        return len(self.runs) == 1

    def widths(self) -> Tuple[int, ...]:
        """Distinct run widths, widest first (the kernel's width codes)."""
        present = {b for _, _, b in self.runs}
        return tuple(b for b in WIDTHS if b in present)

    def run_lengths(self) -> Tuple[int, ...]:
        return tuple(e - s for s, e, _ in self.runs)

    def _run_bytes(self, run, k: int) -> int:
        s, e, b = run
        return (padded_size(k) // pack_factor(b)) * (e - s)

    def packed_bytes(self, k: int) -> int:
        """Container bytes of a (K=k, N=self.n) weight matrix:
        ``sum(run_len * K_pad * bits / 8)``."""
        return sum(self._run_bytes(r, k) for r in self.runs)

    def seg_offsets(self, k: int) -> Tuple[int, ...]:
        """Byte offset of each run's container block in the flat buffer."""
        offs, off = [], 0
        for r in self.runs:
            offs.append(off)
            off += self._run_bytes(r, k)
        return tuple(offs)

    def tile_table(self, k: int):
        """Per-N-tile kernel descriptors ``(codes, offsets)``: int32 numpy
        arrays with one entry per CHUNK-wide output-channel tile.
        ``codes[j]`` indexes `widths()`; ``offsets[j]`` is the byte offset
        of tile j's contiguous column panel in the flat buffer. N must
        already be a CHUNK multiple (`pad_segmented`)."""
        if self.n % CHUNK:
            raise ValueError(
                f"tile_table: N={self.n} is not a CHUNK multiple; pad the "
                "container first (pad_segmented)")
        widths = self.widths()
        kp = padded_size(k)
        codes, offs = [], []
        off = 0
        for s, e, b in self.runs:
            rows = kp // pack_factor(b)
            for _ in range(s, e, CHUNK):
                codes.append(widths.index(b))
                offs.append(off)
                off += rows * CHUNK
        return (np.asarray(codes, np.int32), np.asarray(offs, np.int32))

    def pad_to(self, n_pad: int) -> "SegmentMap":
        """Extend the final run to ``n_pad`` (zero-channel padding)."""
        if n_pad < self.n:
            raise ValueError(f"pad_to: {n_pad} < N={self.n}")
        if n_pad == self.n:
            return self
        s, _, b = self.runs[-1]
        return SegmentMap(self.runs[:-1] + ((s, int(n_pad), b),))

    def to_json_obj(self):
        return [[s, e, b] for s, e, b in self.runs]

    @staticmethod
    def from_json_obj(obj) -> "SegmentMap":
        return SegmentMap(tuple((int(s), int(e), int(b))
                                for s, e, b in obj))


def _iter_panels(length: int):
    """(panel_start, panel_width) pairs tiling ``length`` by CHUNK."""
    for p0 in range(0, length, CHUNK):
        yield p0, min(CHUNK, length - p0)


def pack_segmented(w_hat: torch.Tensor, segmap: SegmentMap, *,
                   assert_range: bool = False) -> torch.Tensor:
    """Pack int8 weight values (..., K, N) into one flat segmented buffer
    (..., segmap.packed_bytes(K)).

    Run ``(s, e, b)`` packs columns [s, e) chunk-planar along K at width
    ``b`` (K zero-padded to CHUNK), flattened panel-major: panels of CHUNK
    output channels, each panel's packed rows contiguous (row stride = the
    panel's width). Per-run offsets are `segmap.seg_offsets(K)`.
    """
    n = w_hat.shape[-1]
    if n != segmap.n:
        raise ValueError(
            f"pack_segmented: weight N={n} != SegmentMap N={segmap.n}")
    lead = w_hat.shape[:-2]
    parts = []
    for s, e, b in segmap.runs:
        seg = w_hat[..., s:e]
        if assert_range:
            check_range(seg, b, True)
        packed = pack(pad_to_chunk(seg, axis=-2), b, axis=-2)
        rows = packed.shape[-2]
        for p0, pw in _iter_panels(e - s):
            parts.append(packed[..., p0:p0 + pw].reshape(*lead, rows * pw))
    return torch.cat(parts, dim=-1).to(torch.int8)


def segment_packed(buf: torch.Tensor, segmap: SegmentMap, index: int,
                   k: int) -> torch.Tensor:
    """Run ``index``'s uniform container view (..., K_pad/pf_b, run_len):
    exactly what `pack` gives for that column range."""
    s, e, b = segmap.runs[index]
    rows = padded_size(k) // pack_factor(b)
    pos = segmap.seg_offsets(k)[index]
    lead = buf.shape[:-1]
    parts = []
    for _, pw in _iter_panels(e - s):
        parts.append(buf[..., pos:pos + rows * pw].reshape(*lead, rows, pw))
        pos += rows * pw
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def unpack_segmented(buf: torch.Tensor, segmap: SegmentMap,
                     k: int) -> torch.Tensor:
    """Inverse of `pack_segmented`: (..., K_pad, N) int8 values (slice
    ``[..., :k, :]`` for the logical matrix)."""
    return torch.cat([unpack(segment_packed(buf, segmap, i, k), b, True,
                             axis=-2)
                      for i, (_, _, b) in enumerate(segmap.runs)], dim=-1)


def pad_segmented(buf: torch.Tensor, segmap: SegmentMap, k: int):
    """Zero-pad the ragged tail panel to a full CHUNK of output channels.

    For kernel callers only (the artifact stays exact-bytes): the
    mixed-operand kernel needs every N tile to be a full contiguous
    CHUNK-wide panel. Returns ``(buf_padded, segmap_padded)``, the inputs
    themselves when N is aligned.
    """
    n = segmap.n
    n_pad = padded_size(n)
    if n_pad == n:
        return buf, segmap
    _, _, b = segmap.runs[-1]
    rows = padded_size(k) // pack_factor(b)
    rem = n - (n // CHUNK) * CHUNK          # ragged tail panel width
    tail_bytes = rows * rem
    lead = buf.shape[:-1]
    head = buf[..., :buf.shape[-1] - tail_bytes]
    tail = buf[..., buf.shape[-1] - tail_bytes:].reshape(*lead, rows, rem)
    tail = torch.nn.functional.pad(tail, (0, CHUNK - rem))
    return (torch.cat([head, tail.reshape(*lead, rows * CHUNK)], dim=-1),
            segmap.pad_to(n_pad))
