"""The conv kernel's real-channel K order, checked on the CPU.

`conv_k_plan` is the one place that maps the CUDA conv kernel's logical K
(taps x real channels, cut into stages) to the image's bytes and fields
and the artifact's packed weight rows, and so the pixel strides the
gather takes; `qconv_k_order_torch` gathers and unpacks through its tables
exactly as the kernel does, on the image the kernel reads (unpadded,
copied by `conv_staging` / `stage_image` only where the stride rule asks),
taps outside it as zeros. Both are held here against the JAX reference
(`repro.kernels.api.qconv` with `xla` and `eager_ref`, and the numpy
direct convolution `qconv2d_ref`) on the reference's own artifact bytes,
at every width pair, exactly. The kernel itself runs only on the card
(`test_torch_cuda.py`).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import api as r_api
from repro.kernels.qconv import ops as r_ops
from repro.kernels.qconv.ref import qconv2d_ref
from repro.kernels.qmatmul.ref import unpack_np
from repro_torch.core import packing
from repro_torch.kernels.qconv.kernel import (MMA_K, conv_k_plan,
                                              conv_stage_k, conv_staging,
                                              conv_tile_n,
                                              qconv_k_order_torch,
                                              stage_image)
from repro_torch.kernels.qmatmul.kernel import k_splits

from torch_bridge import assert_same

r_q = importlib.import_module("repro.core.quantize")

# (n, h, w, cin, cout, f, stride, padding): Cin 1 and 3 (many taps per
# stage), 160 and 200 (two chunks, the second ragged), Cout 10, 48, 200, a
# 1x1 stride-2 conv, 5x5 convs, and Wo = 7 or 13, which do not divide the
# kernel's 128-pixel tile; then the border and the pixel strides: Cin 12
# (copied to 16), 16 (read as it lies) at padding 0 and stride 2, the
# 1x1/s2/p0 skip at Cin 16, Cin 130 (copied to 144) at padding 2, Cin 200
# (to 208) at stride 2, and the depthwise per-group cin = cout = 1 conv
GEOMS = {
    "5x5_cin1_cout10": (2, 9, 7, 1, 10, 5, 1, 2),
    "3x3_cin3_cout48": (2, 11, 9, 3, 48, 3, 1, 1),
    "3x3s2_cin160_cout200": (1, 8, 8, 160, 200, 3, 2, 1),
    "1x1s2_cin200_cout48": (2, 9, 9, 200, 48, 1, 2, 0),
    "5x5_cin3_cout200": (1, 7, 13, 3, 200, 5, 1, 2),
    "3x3_cin12_cout20": (2, 6, 7, 12, 20, 3, 1, 1),
    "3x3s2p0_cin16_cout32": (2, 9, 8, 16, 32, 3, 2, 0),
    "1x1s2p0_cin16_cout32": (2, 8, 8, 16, 32, 1, 2, 0),
    "3x3p2_cin130_cout24": (1, 6, 5, 130, 24, 3, 1, 2),
    "3x3s2_cin200_cout16": (1, 7, 7, 200, 16, 3, 2, 1),
    "3x3s2_cin1_cout1": (2, 8, 8, 1, 1, 3, 2, 1),
}
BITS = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2)]


def _layer(geom, a_bits, w_bits):
    """A conv quantized by the reference from numpy numbers, and integer
    images for it."""
    n, h, w_, cin, cout, f, s, p = GEOMS[geom]
    rng = np.random.default_rng(a_bits * 10 + w_bits + cin)
    w = rng.normal(size=(f, f, cin, cout)).astype(np.float32)
    bn_s = (rng.normal(size=(cout,)) * 0.2 + 0.6).astype(np.float32)
    bn_b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    ref = r_ops.quantize_conv(
        jnp.asarray(w), r_q.QuantSpec.weight(w_bits, float(np.abs(w).max())),
        bn_s, bn_b, r_q.QuantSpec.activation(a_bits, 1.0),
        r_q.QuantSpec.activation(a_bits, 0.5 * f * f), stride=s, padding=p)
    hi = packing.int_range(a_bits, False)[1]
    x = rng.integers(0, hi + 1, size=(n, h, w_, cin)).astype(np.int8)
    return ref, x


def _k_order(ref, x, epilogue="int", scale=1.0):
    """The kernel's gather and unpack order in torch, on the reference's
    artifact bytes and the image as the kernel's wrapper hands it over
    (``x``: numpy, or a torch view, maybe not contiguous)."""
    g = ref.gemm
    x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    cin = x.shape[-1]
    plan = conv_k_plan(ref.fh, ref.fw, cin, g.a_bits, g.w_bits,
                       conv_stage_k(ref.cout))
    staged = conv_staging(x, plan, a_bits=g.a_bits, cin_pad=ref.cin_pad)
    xs = x if staged is None else stage_image(x, staged, g.a_bits)
    return qconv_k_order_torch(
        xs, torch.from_numpy(np.array(ref.w_packed_fused)),
        *(torch.from_numpy(np.array(v)) for v in (g.kappa, g.lam, g.m)),
        fh=ref.fh, fw=ref.fw, stride=ref.stride, padding=ref.padding,
        cin=cin, cin_pad=ref.cin_pad, cout=ref.cout, a_bits=g.a_bits,
        a_signed=g.a_signed, w_bits=g.w_bits, d=g.d, out_bits=g.out_bits,
        epilogue=epilogue, scale=scale)


def _held_against_reference(ref, x, out):
    xj = jnp.asarray(x)
    for backend in ("xla", "eager_ref"):
        assert_same(out, r_api.qconv(ref, xj, backend=backend), backend)
    g = ref.gemm
    w_flat = unpack_np(np.asarray(ref.w_packed_fused), g.w_bits, True, 0)
    w_hat = w_flat.reshape(ref.fh * ref.fw, ref.cin_pad, ref.cout)[
        :, :ref.cin].reshape(ref.fh, ref.fw, ref.cin, ref.cout)
    assert_same(out, qconv2d_ref(x, w_hat, np.asarray(g.kappa),
                                 np.asarray(g.lam), np.asarray(g.m), g.d,
                                 g.out_bits, stride=ref.stride,
                                 padding=ref.padding), "qconv2d_ref")


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_k_order_matches_reference(geom, a_bits, w_bits):
    ref, x = _layer(geom, a_bits, w_bits)
    _held_against_reference(ref, x, _k_order(ref, x))


@pytest.mark.parametrize("geom", ["3x3s2_cin1_cout1",
                                  "3x3s2p0_cin16_cout32",
                                  "3x3_cin12_cout20"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_k_order_on_a_channel_slice_matches_reference(geom, a_bits,
                                                      w_bits):
    """The image a non-contiguous channel slice of a wider one (the
    depthwise per-group lowering's cin = 1 slices): copied first, then the
    same result."""
    ref, x = _layer(geom, a_bits, w_bits)
    n, h, w_, cin = x.shape
    wide = np.random.default_rng(cin).integers(
        0, packing.int_range(a_bits, False)[1] + 1,
        size=(n, h, w_, cin + 7)).astype(np.int8)
    wide[..., 3:3 + cin] = x
    view = torch.from_numpy(wide)[..., 3:3 + cin]
    assert not view.is_contiguous()
    _held_against_reference(ref, x, _k_order(ref, view))


@pytest.mark.parametrize("epilogue", ["raw", "dequant"])
@pytest.mark.parametrize("geom", ["3x3s2_cin160_cout200",
                                  "5x5_cin1_cout10"])
def test_k_order_raw_and_dequant_match_reference(geom, epilogue):
    ref, x = _layer(geom, 4, 2)
    out = _k_order(ref, x, epilogue=epilogue, scale=0.0071)
    assert_same(out, r_api.qconv(ref, jnp.asarray(x), epilogue=epilogue,
                                 scale=0.0071, backend="xla"), epilogue)


@pytest.mark.parametrize("stage_k", [128, 192])
@pytest.mark.parametrize("cin", [1, 3, 5, 16, 32, 64, 100, 128, 160, 200])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_plan_covers_each_real_channel_once(cin, a_bits, w_bits, stage_k):
    """Every (tap, real channel) is contracted exactly once, at its byte
    and field, within the kernel's ring and tile bounds; the only other
    channels are the artifact's zero padding up to a multiple of 4."""
    fh = fw = 3
    plan = conv_k_plan(fh, fw, cin, a_bits, w_bits, stage_k)
    sub_a = packing.CHUNK // packing.pack_factor(a_bits)
    sub_w = packing.CHUNK // packing.pack_factor(w_bits)
    seen = []
    for s, (seg0, nseg, kreal, kstage, a_bytes, gran, a_stride, w_rows) \
            in enumerate(plan.stages.tolist()):
        assert kreal <= kstage <= stage_k and kstage % MMA_K == 0
        assert kstage - kreal < MMA_K
        assert a_bytes % gran == 0 and gran in (4, 16)
        assert nseg * a_stride <= stage_k
        assert nseg * w_rows <= stage_k
        assert (plan.kmap[s, kreal:] == -1).all()
        nch = kreal // nseg
        for k in range(kreal):
            e = int(plan.kmap[s, k])
            i, ch = divmod(k, nch)
            tap, chunk = plan.segs[seg0 + i].tolist()
            c = chunk * packing.CHUNK + ch
            # channel c of the tap: byte c % sub, field c // sub of its chunk
            assert (e & 0xFF) - i * a_stride == ch % sub_a < a_bytes
            assert (e >> 8) & 3 == ch // sub_a
            assert ((e >> 10) & 0xFF) - i * w_rows == ch % sub_w < w_rows
            assert (e >> 18) & 3 == ch // sub_w
            seen.append((tap, c))
    real = [(t, c) for t, c in seen if c < cin]
    assert sorted(real) == [(t, c) for t in range(fh * fw)
                            for c in range(cin)]
    assert all(c < -(-cin // 4) * 4 for _, c in seen)
    # 8-bit activations of a multiple of 4 channels per tap need no unpack
    if a_bits == 8 and (cin < 16 or cin % 16 == 0):
        assert not plan.unpacks_activations(a_bits)


def test_plan_contracts_resnet8_widths():
    """K per output pixel and stages at ResNet-8's convs (stages of 192):
    the stem 64 (3 channels taken as 4, not 9 x 128), Cin 16 taps 160 in
    one stage, Cin 32 288 in two, Cin 64 576 in three, the 1x1 skips
    (Cin 16, 32) 32."""
    plans = {(f, cin): conv_k_plan(f, f, cin, 8, 8, 192)
             for f, cin in ((3, 3), (3, 16), (3, 32), (3, 64), (1, 16),
                            (1, 32))}
    assert {g: (p.k_contracted, len(p.stages)) for g, p in plans.items()} \
        == {(3, 3): (64, 1), (3, 16): (160, 1), (3, 32): (288, 2),
            (3, 64): (576, 3), (1, 16): (32, 1), (1, 32): (32, 1)}
    # sub-byte activations unpack, so the stem keeps its 3 channels
    assert conv_k_plan(3, 3, 3, 2, 2, 192).k_contracted == 32
    # sub-byte widths read fewer bytes, not fewer channels
    assert conv_k_plan(3, 3, 16, 2, 2, 192).k_contracted == 160
    assert conv_stage_k(64) == 192 and conv_stage_k(200) == 128


@pytest.mark.parametrize("cin", [1, 3, 4, 5, 8, 12, 16, 48, 64, 100, 128,
                                 130, 160, 200, 256])
@pytest.mark.parametrize("a_bits", [8, 4, 2])
def test_plan_stride_rule(cin, a_bits):
    """The pixel strides the gather takes: every copy lies within
    ``pixel_bytes`` of a pixel and starts on its granule. 8-bit images are
    read as they lie at Cin 4, 8 and multiples of 16 only, and otherwise
    take ``min_stride`` bytes, the fewest that fit (Cin 1-4 -> 4, 5-8 ->
    8, else the next multiple of 16); sub-byte images packed to cin_pad
    always fit."""
    plan = conv_k_plan(3, 3, cin, a_bits, 4, 192)
    sub_a = packing.CHUNK // packing.pack_factor(a_bits)
    ends = []
    for seg0, nseg, _, _, a_bytes, gran, _, _ in plan.stages.tolist():
        assert gran <= plan.granule and a_bytes % gran == 0
        for _, chunk in plan.segs[seg0:seg0 + nseg].tolist():
            assert chunk * sub_a % plan.granule == 0
            ends.append(chunk * sub_a + a_bytes)
    assert plan.pixel_bytes == max(ends)
    if a_bits == 8:
        assert plan.takes_stride(cin) == (cin % 16 == 0 or cin in (4, 8))
        want = 4 if cin <= 4 else 8 if cin <= 8 else -(-cin // 16) * 16
        assert plan.min_stride == want and plan.takes_stride(want)
        assert not any(plan.takes_stride(c) for c in range(cin, want))
    else:
        cp = packing.padded_size(cin) // packing.pack_factor(a_bits)
        assert plan.takes_stride(cp) and plan.min_stride <= cp


def _image(cin, layout, n=2, h=5, w=3):
    """An int8 image of ``cin`` channels: contiguous, a channel slice of a
    wider one, or contiguous at an address off the 16-byte grid."""
    numel = n * h * w * cin
    vals = torch.arange(numel, dtype=torch.int32).remainder(100).to(
        torch.int8) + 1
    if layout == "contiguous":
        return vals.reshape(n, h, w, cin)
    if layout == "slice":
        wide = torch.zeros((n, h, w, cin + 5), dtype=torch.int8)
        wide[..., 2:2 + cin] = vals.reshape(n, h, w, cin)
        return wide[..., 2:2 + cin]
    buf = torch.zeros(numel + 32, dtype=torch.int8)
    off = next(o for o in range(1, 16) if (buf.data_ptr() + o) % 16)
    buf[off:off + numel] = vals
    x = buf[off:off + numel].reshape(n, h, w, cin)
    assert x.is_contiguous() and x.data_ptr() % 16
    return x


@pytest.mark.parametrize("a_bits,cin,layout,want", [
    (8, 16, "contiguous", None), (8, 4, "contiguous", None),
    (8, 8, "contiguous", None), (8, 64, "contiguous", None),
    (8, 144, "contiguous", None),
    (8, 3, "contiguous", 4), (8, 1, "contiguous", 4),
    (8, 5, "contiguous", 8), (8, 12, "contiguous", 16),
    (8, 130, "contiguous", 144), (8, 200, "contiguous", 208),
    (8, 16, "slice", 16), (8, 1, "slice", 4), (8, 3, "slice", 4),
    (8, 16, "misaligned", 16), (8, 4, "misaligned", 4),
    (4, 16, "contiguous", 128), (2, 3, "contiguous", 128),
    (4, 130, "contiguous", 256), (2, 16, "slice", 128),
])
def test_staging_copies_only_what_the_granule_demands(a_bits, cin, layout,
                                                      want):
    """Which images the kernel reads as they are (None) and which are
    copied first, to how many channels; the copy keeps H and W (no
    border: the kernel supplies it), is contiguous and 16-byte aligned,
    holds the real channels then zeros, packed chunk-planar below 8 bits,
    and is a stride the plan takes."""
    x = _image(cin, layout)
    plan = conv_k_plan(3, 3, cin, a_bits, 8, 192)
    cin_pad = packing.padded_size(cin)
    assert conv_staging(x, plan, a_bits=a_bits, cin_pad=cin_pad) == want
    if want is None:
        return
    xs = stage_image(x, want, a_bits)
    pf = packing.pack_factor(a_bits)
    assert tuple(xs.shape) == (*x.shape[:-1], want // pf)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 0
    assert plan.takes_stride(xs.shape[-1])
    widened = torch.nn.functional.pad(x, (0, want - cin))
    assert torch.equal(xs, packing.pack(widened, a_bits, axis=-1))


def test_conv_tile_is_cout_rounded_to_a_wgmma_width():
    assert [conv_tile_n(c) for c in (3, 10, 16, 17, 48, 64, 70, 200, 256,
                                     300)] == [16, 16, 16, 32, 64, 64, 128,
                                               256, 256, 256]


def test_k_split_fills_the_card_only_when_tiles_do_not():
    # c3 of qat-cnn at a wave: 98 x 2 tiles of 128 x 128, no split
    assert k_splits(98 * 2, 3, 132) == 1
    # fig8 256x2048x256: 2 x 2 tiles, 16 stages -> one cluster of 8
    # blocks per tile, two stages each
    assert k_splits(4, 16, 132) == 8
    # every block keeps at least one stage; a tile's blocks fit a cluster
    for tiles, stages in ((3, 2), (2, 2), (1, 2), (128, 3), (7, 18)):
        splits = k_splits(tiles, stages, 132)
        per = -(-stages // splits)
        assert 1 <= splits <= min(stages, 8)
        assert (splits - 1) * per < stages


@pytest.mark.parametrize("name", ["qconv", "qmatmul", "qmatmul_segmented"])
def test_ctypes_binding_matches_the_c_entry_point(name):
    """Each kernel's ctypes argument types are its C entry point's
    parameters, one for one: ctypes passes arguments past ``argtypes``
    unconverted, so a missing entry shifts the stream pointer and
    crashes the launch on the card."""
    import ctypes
    import re

    from repro_torch.kernels.qconv.kernel import KERNEL as qconv
    from repro_torch.kernels.qmatmul.kernel import KERNEL as qmatmul
    from repro_torch.kernels.qmatmul.kernel import SEGMENTED_KERNEL

    kernel = {"qconv": qconv, "qmatmul": qmatmul,
              "qmatmul_segmented": SEGMENTED_KERNEL}[name]
    src = kernel.source.read_text()
    params = re.search(r'extern "C" int ' + kernel.entry + r"\((.*?)\)\s*\{",
                       src, re.S).group(1)
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else ctype[p.split()[-2]]
            for p in (q.strip() for q in params.split(","))]
    assert kernel.argtypes == want
