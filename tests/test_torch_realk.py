"""The conv kernel's real-channel K order, checked on the CPU.

`conv_k_plan` is the one place that maps the CUDA conv kernel's logical K
(taps x real channels, cut into stages) to the artifact's packed bytes,
fields and weight rows; `qconv_k_order_torch` gathers and unpacks through
its tables exactly as the kernel does. Both are held here against the JAX
reference (`repro.kernels.api.qconv` with `xla` and `eager_ref`, and the
numpy direct convolution `qconv2d_ref`) on the reference's own artifact
bytes, at every width pair, exactly. The kernel itself runs only on the
card (`test_torch_cuda.py`).
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
                                              conv_out_hw, conv_stage_k,
                                              conv_tile_n, pad_and_pack,
                                              qconv_k_order_torch)
from repro_torch.kernels.qmatmul.kernel import k_splits

from torch_bridge import assert_same

r_q = importlib.import_module("repro.core.quantize")

# (n, h, w, cin, cout, f, stride, padding): Cin 1 and 3 (many taps per
# stage), 160 and 200 (two chunks, the second ragged), Cout 10, 48, 200, a
# 1x1 stride-2 conv, 5x5 convs, and Wo = 7 or 13, which do not divide the
# kernel's 128-pixel tile
GEOMS = {
    "5x5_cin1_cout10": (2, 9, 7, 1, 10, 5, 1, 2),
    "3x3_cin3_cout48": (2, 11, 9, 3, 48, 3, 1, 1),
    "3x3s2_cin160_cout200": (1, 8, 8, 160, 200, 3, 2, 1),
    "1x1s2_cin200_cout48": (2, 9, 9, 200, 48, 1, 2, 0),
    "5x5_cin3_cout200": (1, 7, 13, 3, 200, 5, 1, 2),
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
    artifact bytes."""
    g = ref.gemm
    n, h, w_, cin = x.shape
    ho, wo = conv_out_hw(h, w_, ref.fh, ref.fw, ref.stride, ref.padding)
    xp = pad_and_pack(torch.from_numpy(x), padding=ref.padding,
                      cin_pad=ref.cin_pad, a_bits=g.a_bits)
    return qconv_k_order_torch(
        xp, torch.from_numpy(np.array(ref.w_packed_fused)),
        *(torch.from_numpy(np.array(v)) for v in (g.kappa, g.lam, g.m)),
        fh=ref.fh, fw=ref.fw, stride=ref.stride, ho=ho, wo=wo, cin=cin,
        cin_pad=ref.cin_pad, cout=ref.cout, a_bits=g.a_bits,
        a_signed=g.a_signed, w_bits=g.w_bits, d=g.d, out_bits=g.out_bits,
        epilogue=epilogue, scale=scale)


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_k_order_matches_reference(geom, a_bits, w_bits):
    ref, x = _layer(geom, a_bits, w_bits)
    out = _k_order(ref, x)
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
