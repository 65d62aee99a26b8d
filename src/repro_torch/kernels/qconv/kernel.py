"""Fused implicit-GEMM quantized conv: the CUDA kernel and its plain
version.

`qconv2d_fused` dispatches on the device. CUDA tensors launch the Hopper
kernel (``csrc/qconv.cu``, STAGES 1 or 2 for pipeline 'off' or
'double_buffer') on the integer images as they are: the kernel's gather
supplies the conv's zero border and reads each pixel at the image's own
stride. Only an image whose pixel stride, layout or alignment the
gather's copy granule cannot take is copied first, to the fewest
channels that satisfy it (`conv_staging`): 8-bit activations of a
channel count other than 4, 8 or a multiple of 16 (the 3-channel stem
to 4), a non-contiguous or misaligned image, and sub-byte activations,
whose chunk-planar bytes the wrapper packs to ``cin_pad`` channels. CPU
tensors run `qconv_packed_torch`, the per-tap gather + contraction +
epilogue in torch on the image padded spatially and per tap to
``cin_pad`` channels, as the reference pads outside its Pallas kernel.
No fallback from one to the other.

The kernel contracts the real channels only. `conv_k_plan` is the one
place that maps the kernel's logical K (taps x real channels, in stages
of at most `conv_stage_k` values) to the image's bytes, fields and the
packed artifact's weight rows, and so the pixel strides the gather may
read at (`ConvKPlan.takes_stride`); the kernel reads its tables, and
`qconv_k_order_torch` gathers and unpacks through the same tables on the
CPU, border included, so the tests hold that index math against the
reference.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core import packing
from repro_torch.core.quantize import wrap_int32
from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.common import (EPILOGUE_DTYPES, PIPELINE_STAGES,
                                        apply_epilogue, check_pipeline,
                                        int_matmul, matmul_planes)
from repro_torch.kernels.qmatmul.kernel import _check, epilogue_launch_args
from repro_torch.obs import accounting

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "qconv", "qconv.cu", "qconv_launch",
    [_P] * 5 + [_I] * 3 + [_P] * 4 + [ctypes.c_float, _P] + [_I] * 19
    + [_P])

# wgmma's k for 8-bit operands: each stage's K is rounded up to it
MMA_K = 32
# shared memory a block keeps for its copy of the stage plan
PLAN_SMEM_BYTES = 16 * 1024


def conv_tile_n(cout: int) -> int:
    """The kernel's column tile: Cout rounded up to 16, 32, 64, 128 or
    256 (wider convs take several tiles). wgmma's n."""
    return min(256, max(16, 1 << (cout - 1).bit_length()))


def conv_stage_k(cout: int) -> int:
    """Logical K per stage of the kernel (``stage_k`` in csrc/qconv.cu):
    192, so that a 3x3 conv over 16 channels takes one stage, except with
    the 256-wide column tile, whose shared memory leaves room for 128.
    A stage also holds at most as many gathered bytes per pixel and packed
    weight rows."""
    return 192 if conv_tile_n(cout) <= 128 else 128


@dataclasses.dataclass(frozen=True)
class ConvKPlan:
    """The kernel's K order for one conv geometry and width pair.

    ``stages`` (S, 8) int32: first segment, segments, K before rounding,
    K rounded up to MMA_K, x bytes copied per segment, copy granule (4 or
    16), ring bytes per segment, weight rows per segment. ``segs`` (G, 2)
    int32: a segment's (tap, channel chunk). ``kmap`` (S, stage_k) int32:
    for each logical k of a stage, its x ring byte (bits 0-7) and field
    (8-9) and its weight ring row (10-17) and field (18-19); -1 past the
    stage's K. ``pixel_bytes``: the bytes of an image pixel the gather
    reads (the end of its furthest copy); ``granule``: the widest copy
    (4 or 16 bytes), whose alignment every copy's source needs.
    """

    stages: np.ndarray
    segs: np.ndarray
    kmap: np.ndarray
    pixel_bytes: int
    granule: int

    def takes_stride(self, cp: int) -> bool:
        """Whether the gather can read an image of ``cp`` bytes a pixel
        (16-byte aligned) as it lies: every copy within the pixel and
        every copy's source on its granule."""
        return cp >= self.pixel_bytes and cp % self.granule == 0

    @property
    def min_stride(self) -> int:
        """The fewest bytes a pixel the gather takes: `pixel_bytes`
        rounded up to the granule (8-bit: Cin 3 -> 4, 12 -> 16, 130 ->
        144; a Cin of 4, 8 or a multiple of 16 is its own)."""
        return -(-self.pixel_bytes // self.granule) * self.granule

    @property
    def k_contracted(self) -> int:
        """K the tensor cores contract per output pixel."""
        return int(self.stages[:, 3].sum())

    def unpacks_activations(self, a_bits: int) -> bool:
        """Whether some stage unpacks its gathered activation bytes (and
        so needs the kernel's activation ring): sub-byte activations, or
        a stage whose segments do not lie back to back in the ring.
        Otherwise the kernel copies the bytes straight into its A tile."""
        nch = self.stages[:, 2] // self.stages[:, 1]
        return a_bits != 8 or bool((self.stages[:, 6] != nch).any())


def conv_k_plan(fh: int, fw: int, cin: int, a_bits: int, w_bits: int,
                stage_k: int) -> ConvKPlan:
    """Cut the conv's logical K (taps x the ``cin`` real channels) into
    the kernel's stages of at most ``stage_k`` values.

    In a chunk-planar CHUNK channel c sits in byte c % (CHUNK/pf), field
    c / (CHUNK/pf), so a tap's real channels occupy the first
    min(Cin, CHUNK/pf) bytes of each pixel chunk and as many packed weight
    rows. With Cin <= CHUNK a stage holds as many whole taps as fit in
    stage_k values, gathered bytes and weight rows; with Cin > CHUNK it
    holds one chunk of one tap. Each stage's K is rounded up to MMA_K
    once. 8-bit activations of fewer than 16 channels take a multiple of
    4 channels per tap (the image's copy, widened to 4, 8 or 16
    channels, fills the rest with zeros), so a stage's bytes lie back to
    back and need no unpacking. The copies fix the pixel strides the gather
    takes (`ConvKPlan.takes_stride`).
    """
    sub_a = packing.CHUNK // packing.pack_factor(a_bits)
    sub_w = packing.CHUNK // packing.pack_factor(w_bits)
    taps = fh * fw
    if cin <= 0:
        raise ValueError(f"cin={cin}")

    def ring_bytes(nch):  # (bytes copied, granule) of one segment
        nb = min(nch, sub_a)
        gran = 16 if nb > 8 else 4
        return -(-nb // gran) * gran, gran

    groups = []  # (segments [(tap, chunk)], channels per segment)
    if cin <= packing.CHUNK:
        nch = -(-cin // 4) * 4 if a_bits == 8 and cin < 16 else cin
        per = min(taps, stage_k // nch, stage_k // ring_bytes(nch)[0],
                  stage_k // min(nch, sub_w))
        for t0 in range(0, taps, per):
            groups.append(([(t, 0) for t in range(t0, min(t0 + per, taps))],
                           nch))
    else:
        for t in range(taps):
            for c in range(-(-cin // packing.CHUNK)):
                groups.append(([(t, c)],
                               min(packing.CHUNK, cin - c * packing.CHUNK)))
    stages, segs, pixel_bytes = [], [], 0
    kmap = np.full((len(groups), stage_k), -1, np.int32)
    for s, (seg, nch) in enumerate(groups):
        stride, gran = ring_bytes(nch)
        rows = min(nch, sub_w)
        kreal = len(seg) * nch
        stages.append((len(segs), len(seg), kreal,
                       -(-kreal // MMA_K) * MMA_K, stride, gran, stride,
                       rows))
        segs.extend(seg)
        pixel_bytes = max(pixel_bytes, max(c for _, c in seg) * sub_a
                          + stride)
        k = np.arange(kreal)
        i, ch = k // nch, k % nch
        kmap[s, :kreal] = ((i * stride + ch % sub_a) | (ch // sub_a) << 8
                           | (i * rows + ch % sub_w) << 10
                           | (ch // sub_w) << 18)
    stages = np.asarray(stages, np.int32)
    return ConvKPlan(stages, np.asarray(segs, np.int32).reshape(-1, 2), kmap,
                     pixel_bytes, int(stages[:, 5].max()))


cached_k_plan = functools.lru_cache(maxsize=256)(conv_k_plan)


@functools.lru_cache(maxsize=256)
def conv_plan_tensors(fh: int, fw: int, cin: int, a_bits: int, w_bits: int,
                      stage_k: int, device: torch.device):
    """`conv_k_plan`'s (stages, segs, kmap) as int32 tensors on
    ``device``, and whether the kernel unpacks activations, built once
    per geometry, widths, stage depth and device."""
    plan = cached_k_plan(fh, fw, cin, a_bits, w_bits, stage_k)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (plan.stages, plan.segs, plan.kmap)) + (
                     plan.unpacks_activations(a_bits),)


def conv_out_hw(h: int, w: int, fh: int, fw: int, stride: int,
                padding: int):
    return ((h + 2 * padding - fh) // stride + 1,
            (w + 2 * padding - fw) // stride + 1)


def pad_and_pack(x_hat: torch.Tensor, *, padding: int, cin_pad: int,
                 a_bits: int) -> torch.Tensor:
    """(N, H, W, Cin) int8 images -> (N, H+2p, W+2p, cin_pad/pf_a) packed:
    the plain version's input, shaped as the reference's."""
    cin = x_hat.shape[-1]
    x = F.pad(x_hat, (0, cin_pad - cin, padding, padding, padding, padding))
    return packing.pack(x, a_bits, axis=-1)


def conv_staging(x_hat: torch.Tensor, plan: ConvKPlan, *, a_bits: int,
                 cin_pad: int):
    """Channels the kernel's copy of ``x_hat`` (N, H, W, Cin) holds, or
    None where the kernel reads the image as it is: 8-bit activations in
    a contiguous, 16-byte aligned image whose Cin is a stride ``plan``
    takes. Other 8-bit images are copied to the plan's fewest channels
    (Cin 1-4 -> 4, 5-8 -> 8, else the next multiple of 16); sub-byte
    ones are packed chunk-planar, which takes ``cin_pad`` channels. Read
    from the call's own input alone."""
    if a_bits != 8:
        return cin_pad
    cin = x_hat.shape[-1]
    if plan.takes_stride(cin) and x_hat.is_contiguous() \
            and x_hat.data_ptr() % 16 == 0:
        return None
    return plan.min_stride


def stage_image(x_hat: torch.Tensor, channels: int,
                a_bits: int) -> torch.Tensor:
    """The image copied to ``channels`` channels (zeros past Cin), packed
    to ``a_bits``: contiguous, in a fresh (aligned) allocation, with no
    border."""
    cin = x_hat.shape[-1]
    if channels > cin:
        x = F.pad(x_hat, (0, channels - cin))
    elif a_bits == 8:
        x = x_hat.clone(memory_format=torch.contiguous_format)
    else:
        x = x_hat
    return packing.pack(x, a_bits, axis=-1)


def qconv_packed_torch(xp, w_packed_fused, kappa, lam, m_mul, *, fh: int,
                       fw: int, stride: int, ho: int, wo: int, cin_pad: int,
                       cout: int, a_bits: int, a_signed: bool, w_bits: int,
                       d: int, out_bits: int, epilogue: str = "int",
                       scale=1.0) -> torch.Tensor:
    """Plain version on the kernel's inputs: the sum over taps of each
    tap's strided patch @ its rows of the tap-major weight panel, then the
    epilogue. Returns (N, Ho, Wo, Cout)."""
    n, cp = xp.shape[0], xp.shape[-1]
    kpt = cin_pad // packing.pack_factor(w_bits)
    acc = torch.zeros((n * ho * wo, cout), dtype=torch.int64,
                      device=xp.device)
    for t in range(fh * fw):
        dy, dx = divmod(t, fw)
        patch = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                   dx:dx + stride * (wo - 1) + 1:stride, :]
        acc += matmul_planes(patch.reshape(-1, cp),
                             w_packed_fused[t * kpt:(t + 1) * kpt],
                             a_bits, a_signed, w_bits)
    y = apply_epilogue(wrap_int32(acc), kappa, lam, m_mul, d=d,
                       out_bits=out_bits, epilogue=epilogue, scale=scale)
    return y.reshape(n, ho, wo, cout)


def _fields(byte: torch.Tensor, plane: torch.Tensor, bits: int,
            signed: bool) -> torch.Tensor:
    """Bit-field ``plane`` of each packed byte as the value it encodes."""
    if bits == 8:
        return byte.to(torch.int32)
    v = ((byte.to(torch.int32) & 0xFF) >> (bits * plane)) & ((1 << bits) - 1)
    if signed:
        v = torch.where(v >= 1 << (bits - 1), v - (1 << bits), v)
    return v


def _border_gather(x: torch.Tensor, dy: int, dx: int, stride: int,
                   padding: int, ho: int, wo: int) -> torch.Tensor:
    """Tap (dy, dx)'s input pixel of every output pixel, (N, Ho, Wo, cp),
    from the unpadded image ``x``; zeros outside it, as the kernel's
    zero-size copies give."""
    _, h, w, _ = x.shape
    iy = torch.arange(ho, device=x.device) * stride - padding + dy
    ix = torch.arange(wo, device=x.device) * stride - padding + dx
    oky, okx = (iy >= 0) & (iy < h), (ix >= 0) & (ix < w)
    patch = x[:, iy.clamp(0, h - 1)][:, :, ix.clamp(0, w - 1)]
    keep = (oky[:, None] & okx[None, :])[None, :, :, None]
    return patch * keep.to(patch.dtype)


def qconv_k_order_torch(x, w_packed_fused, kappa, lam, m_mul, *, fh: int,
                        fw: int, stride: int, padding: int, cin: int,
                        cin_pad: int, cout: int, a_bits: int,
                        a_signed: bool, w_bits: int, d: int, out_bits: int,
                        epilogue: str = "int", scale=1.0) -> torch.Tensor:
    """The CUDA kernel's data flow in torch, stage by stage of
    `conv_k_plan`, on the image the kernel reads (``x``: (N, H, W, cp),
    unpadded, cp a stride the plan takes): gather each segment's bytes
    into a ring row as the kernel copies them, taps outside the image as
    zeros, unpack through ``kmap`` (zeros past the real K), contract,
    then the epilogue. Returns (N, Ho, Wo, Cout)."""
    stage_k = conv_stage_k(cout)
    plan = conv_k_plan(fh, fw, cin, a_bits, w_bits, stage_k)
    n, h, w, cp = x.shape
    if not plan.takes_stride(cp):
        raise ValueError(f"the gather cannot read {cp} bytes a pixel for "
                         f"Cin={cin} at A{a_bits}")
    ho, wo = conv_out_hw(h, w, fh, fw, stride, padding)
    sub_a = packing.CHUNK // packing.pack_factor(a_bits)
    sub_w = packing.CHUNK // packing.pack_factor(w_bits)
    w_tap_rows = cin_pad // packing.pack_factor(w_bits)
    npix = n * ho * wo
    acc = torch.zeros((npix, cout), dtype=torch.int64, device=x.device)
    for s, (seg0, nseg, _, kstage, a_bytes, _, a_stride, w_rows) in \
            enumerate(plan.stages.tolist()):
        ring_x = torch.zeros((npix, stage_k), dtype=torch.int8,
                             device=x.device)
        ring_w = torch.zeros((stage_k, cout), dtype=torch.int8,
                             device=x.device)
        for i, (tap, chunk) in enumerate(plan.segs[seg0:seg0 + nseg]
                                         .tolist()):
            dy, dx = divmod(tap, fw)
            patch = _border_gather(
                x[..., chunk * sub_a:chunk * sub_a + a_bytes], dy, dx,
                stride, padding, ho, wo)
            ring_x[:, i * a_stride:i * a_stride + a_bytes] = \
                patch.reshape(npix, a_bytes)
            r0 = tap * w_tap_rows + chunk * sub_w
            ring_w[i * w_rows:(i + 1) * w_rows] = \
                w_packed_fused[r0:r0 + w_rows]
        ent = torch.from_numpy(plan.kmap[s, :kstage].astype(np.int64)).to(
            x.device)
        live = ent >= 0
        e = torch.where(live, ent, torch.zeros_like(ent))
        a = _fields(ring_x[:, e & 0xFF], (e >> 8) & 3, a_bits, a_signed)
        b = _fields(ring_w[(e >> 10) & 0xFF], ((e >> 18) & 3)[:, None],
                    w_bits, True)
        acc += int_matmul((a * live).to(torch.int8),
                          (b * live[:, None]).to(torch.int8)).to(torch.int64)
    y = apply_epilogue(wrap_int32(acc), kappa, lam, m_mul, d=d,
                       out_bits=out_bits, epilogue=epilogue, scale=scale)
    return y.reshape(n, ho, wo, cout)


def qconv_packed_cuda(x, w_packed_fused, kappa, lam, m_mul, *, fh: int,
                      fw: int, stride: int, padding: int, cin: int,
                      cin_pad: int, cout: int, a_bits: int, a_signed: bool,
                      w_bits: int, d: int, out_bits: int,
                      epilogue: str = "int", scale=1.0,
                      pipeline: str = "off") -> torch.Tensor:
    """Launch the Hopper conv kernel on ``x`` (N, H, W, cp), the image as
    the kernel reads it: unpadded, contiguous, 16-byte aligned, cp bytes a
    pixel, a stride the plan of its ``cin`` real channels takes (8-bit)
    or ``cin_pad``/pf_a chunk-planar bytes (sub-byte); raises on anything
    it does not take. The kernel supplies the ``padding`` border."""
    stages = PIPELINE_STAGES[check_pipeline(pipeline)]
    dev = x.device
    _check(x, "x", torch.int8, dev, 4)
    _check(w_packed_fused, "w_packed_fused", torch.int8, dev, 2)
    pf_a, pf_w = packing.pack_factor(a_bits), packing.pack_factor(w_bits)
    n, h, w_, cp = x.shape
    if cin_pad % packing.CHUNK or not 0 < cin <= cin_pad:
        raise ValueError(f"cin={cin} does not fit cin_pad={cin_pad}, a "
                         "CHUNK multiple")
    stage_k = conv_stage_k(cout)
    plan = cached_k_plan(fh, fw, cin, a_bits, w_bits, stage_k)
    if not plan.takes_stride(cp) or (a_bits != 8 and cp * pf_a != cin_pad):
        raise ValueError(
            f"image has {cp} bytes per pixel; the gather of Cin={cin} at "
            f"A{a_bits} takes " + (f"a multiple of {plan.granule} from "
                                   f"{plan.pixel_bytes}" if a_bits == 8
                                   else f"cin_pad/pf_a = {cin_pad // pf_a}"))
    if tuple(w_packed_fused.shape) != (fh * fw * cin_pad // pf_w, cout):
        raise ValueError(
            f"w_packed_fused {tuple(w_packed_fused.shape)} != "
            f"({fh * fw * cin_pad // pf_w}, {cout})")
    if max(h, w_, padding) >= 1 << 15 or n * h * w_ >= 1 << 31:
        raise ValueError(f"{n} images of {h}x{w_} with padding {padding} "
                         "exceed the kernel's 16-bit coordinates or 31-bit "
                         "pixel index")
    ho, wo = conv_out_hw(h, w_, fh, fw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty conv output {ho}x{wo}")
    kappa, lam, m_mul, svec, sf, d, hi, code = epilogue_launch_args(
        kappa, lam, m_mul, n=cout, d=d, out_bits=out_bits,
        epilogue=epilogue, scale=scale, device=dev)
    out = torch.empty((n, ho, wo, cout), dtype=EPILOGUE_DTYPES[epilogue],
                      device=dev)
    if out.numel() == 0:
        return out
    st, segs, kmap, a_ring = conv_plan_tensors(
        fh, fw, cin, a_bits, w_bits, stage_k, dev)
    if (st.numel() + segs.numel()) * 4 > PLAN_SMEM_BYTES:
        raise ValueError(
            f"a {fh}x{fw} conv over {cin} channels takes {st.shape[0]} "
            f"stages; the kernel holds at most {PLAN_SMEM_BYTES} bytes of "
            "stage plan in shared memory")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(
            stages, x.data_ptr(), w_packed_fused.data_ptr(), st.data_ptr(),
            segs.data_ptr(), kmap.data_ptr(), st.shape[0], segs.shape[0],
            int(a_ring), kappa.data_ptr(),
            lam.data_ptr(), m_mul.data_ptr(),
            None if svec is None else svec.data_ptr(), sf, out.data_ptr(),
            n, h, w_, cp, ho, wo, fw, stride, padding, cin_pad // pf_w, cout,
            a_bits, w_bits, int(a_signed), d, hi, code, stages,
            conv_tile_n(cout), stream)
    return out


def qconv2d_fused(x_hat, w_packed_fused, kappa, lam, m_mul, *, fh: int,
                  fw: int, stride: int, padding: int, cin_pad: int,
                  cout: int, a_bits: int, a_signed: bool, w_bits: int,
                  d: int, out_bits: int, epilogue: str = "int", scale=1.0,
                  pipeline: str = "off") -> torch.Tensor:
    """Fused implicit-GEMM conv on integer images x_hat (N, H, W, Cin)
    int8 -> (N, Ho, Wo, Cout). ``w_packed_fused`` is the tap-major panel
    from `quantize_conv` (K = fh*fw*cin_pad). Where `conv_staging` copies
    the image first, counters ``qconv.staged`` (calls) and
    ``qconv.staged_bytes`` (bytes of the copy) record it, on any device,
    while observability is on."""
    check_pipeline(pipeline)
    n, h, w_, cin = x_hat.shape
    if cin > cin_pad or cin_pad % packing.CHUNK:
        raise ValueError(f"cin={cin} does not fit cin_pad={cin_pad}")
    ho, wo = conv_out_hw(h, w_, fh, fw, stride, padding)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty conv output {ho}x{wo}")
    staged = conv_staging(
        x_hat, cached_k_plan(fh, fw, cin, a_bits, w_bits, conv_stage_k(cout)),
        a_bits=a_bits, cin_pad=cin_pad)
    if staged is not None:
        obs.counter("qconv.staged").add(1)
        obs.counter("qconv.staged_bytes").add(
            n * h * w_ * staged // packing.pack_factor(a_bits))
    kw = dict(fh=fh, fw=fw, stride=stride, cin_pad=cin_pad, cout=cout,
              a_bits=a_bits, a_signed=a_signed, w_bits=w_bits, d=d,
              out_bits=out_bits, epilogue=epilogue, scale=scale)
    if x_hat.is_cuda:
        x = x_hat if staged is None else stage_image(x_hat, staged, a_bits)
        return qconv_packed_cuda(x, w_packed_fused, kappa, lam, m_mul,
                                 padding=padding, cin=cin, pipeline=pipeline,
                                 **kw)
    xp = pad_and_pack(x_hat, padding=padding, cin_pad=cin_pad,
                      a_bits=a_bits)
    macs = n * ho * wo * fh * fw * cin * cout
    return accounting.packed(
        "qconv", macs, (xp, w_packed_fused, kappa, lam, m_mul, scale),
        lambda: qconv_packed_torch(xp, w_packed_fused, kappa, lam, m_mul,
                                   ho=ho, wo=wo, **kw))
