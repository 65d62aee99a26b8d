"""The Hopper kernels on the card (qmatmul, qconv, qmatmul_segmented),
held exactly against their plain versions run on the same device.
Marked ``cuda``; each test skips where torch sees no GPU (decided inside
the fixture, never at import). Run on a GPU machine with
``PYTHONPATH=src python -m pytest -m cuda tests/``.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels.qconv import kernel as conv_k
from repro_torch.kernels.qmatmul import kernel as gemm_k

pytestmark = pytest.mark.cuda

BITS = list(itertools.product((8, 4, 2), (8, 4, 2)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ints(rng, bits, signed, shape, dev):
    lo, hi = packing.int_range(bits, signed)
    return torch.from_numpy(rng.integers(lo, hi + 1, size=shape).astype(
        np.int8)).to(dev)


def _epilogue_vectors(rng, n, dev):
    return (torch.from_numpy(rng.integers(-127, 128, n).astype(np.int32)),
            torch.from_numpy(rng.integers(-2**20, 2**20, n).astype(
                np.int32)),
            torch.from_numpy(rng.integers(0, 2**15, n).astype(np.int32)))


def _same(a, b):
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qmatmul_kernel_matches_plain(dev, a_bits, w_bits, pipeline):
    rng = np.random.default_rng(a_bits * 10 + w_bits)
    for m, k, n in ((64, 128, 10), (130, 384, 70)):
        x = packing.pack(_ints(rng, a_bits, False, (m, k), dev), a_bits)
        w = packing.pack(_ints(rng, w_bits, True, (k, n), dev), w_bits,
                         axis=0)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, n, dev)]
        for epi in ("int", "raw", "dequant"):
            kw = dict(a_bits=a_bits, a_signed=False, w_bits=w_bits, d=23,
                      out_bits=a_bits, epilogue=epi, scale=0.013)
            got = gemm_k.qmatmul_packed_cuda(x, w, *vecs, pipeline=pipeline,
                                             **kw)
            assert _same(got, gemm_k.qmatmul_packed_torch(x, w, *vecs, **kw))


# (M, K, N) of the uniform GEMM's ragged wall: every K of {1, 31, 33, 64,
# 200, 1000}, N of {1, 10, 17, 100, 128, 200, 384} and M of {1, 64, 100,
# 4096}; the last two are A8 grids of more 128 x 128 tiles than the card
# has SMs, which the plan runs at two blocks per SM. Each at its planned
# launch, with K unsplit, and at A8 with the 128-wide tile at the other
# register budget
GEMM_WALL = ((1, 1, 1), (64, 31, 10), (100, 33, 17), (4096, 64, 100),
             (64, 200, 128), (100, 1000, 200), (1, 64, 384),
             (4096, 1000, 10), (64, 33, 384), (100, 200, 1),
             (4096, 200, 17), (1, 1000, 128), (4096, 200, 1024),
             (4100, 1000, 1000))


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qmatmul_kernel_ragged_wall_matches_plain(dev, a_bits, w_bits,
                                                  pipeline):
    rng = np.random.default_rng(a_bits * 10 + w_bits + 2)
    stages = 1 if pipeline == "off" else 2
    for m, k, n in GEMM_WALL:
        x = packing.pack(packing.pad_to_chunk(
            _ints(rng, a_bits, False, (m, k), dev)), a_bits)
        w = packing.pack(packing.pad_to_chunk(
            _ints(rng, w_bits, True, (k, n), dev), axis=0), w_bits, axis=0)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, n, dev)]
        sms = gemm_k.sm_count(dev)
        plan = gemm_k.gemm_launch_plan(m, n, k, a_bits, sms)
        plans = {plan, gemm_k.gemm_launch_plan(m, n, k, a_bits, sms,
                                               splits=1)}
        if a_bits == 8 and plan.nt == 128:
            plans.add(gemm_k.gemm_launch_plan(
                m, n, k, a_bits, sms, splits=plan.splits,
                min_blocks=3 - plan.min_blocks))
        for epi in ("int", "raw", "dequant"):
            kw = dict(a_bits=a_bits, a_signed=False, w_bits=w_bits, d=23,
                      out_bits=a_bits, epilogue=epi, scale=0.013,
                      k_logical=k)
            want = gemm_k.qmatmul_packed_torch(x, w, *vecs, **kw)
            for launch in plans:
                before = gemm_k.KERNEL.launches[stages]
                got = gemm_k._launch_packed(x, w, *vecs, launch,
                                            pipeline=pipeline, **kw)
                assert gemm_k.KERNEL.launches[stages] == before + 1
                assert _same(got, want), ((m, k, n), epi, launch)
    # a launch planned for another shape is refused
    other = gemm_k.gemm_launch_plan(m, n + 128, k, a_bits, sms)
    with pytest.raises(ValueError, match="not a launch"):
        gemm_k._launch_packed(x, w, *vecs, other, pipeline=pipeline, **kw)


def _conv_pair(x, wpf, vecs, *, f, s, p, cin_pad, cout, pipeline, **kw):
    """(the kernel through `qconv2d_fused` on the unpadded image ``x``,
    the plain version on its spatially padded, packed copy), on the same
    device."""
    got = conv_k.qconv2d_fused(x, wpf, *vecs, fh=f, fw=f, stride=s,
                               padding=p, cin_pad=cin_pad, cout=cout,
                               pipeline=pipeline, **kw)
    ho, wo = conv_k.conv_out_hw(x.shape[1], x.shape[2], f, f, s, p)
    xp = conv_k.pad_and_pack(x, padding=p, cin_pad=cin_pad,
                             a_bits=kw["a_bits"])
    want = conv_k.qconv_packed_torch(xp, wpf, *vecs, fh=f, fw=f, stride=s,
                                     ho=ho, wo=wo, cin_pad=cin_pad,
                                     cout=cout, **kw)
    return got, want


def _conv_weights(rng, w_bits, f, cin, cout, dev):
    """The tap-major fused panel of random weights, each tap's channels
    padded to cin_pad, and cin_pad."""
    cin_pad = packing.padded_size(cin)
    wt = torch.nn.functional.pad(
        _ints(rng, w_bits, True, (f * f, cin, cout), dev),
        (0, 0, 0, cin_pad - cin))
    return packing.pack(wt.reshape(-1, cout), w_bits, axis=0), cin_pad


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qconv_kernel_matches_plain(dev, a_bits, w_bits, pipeline):
    rng = np.random.default_rng(a_bits * 10 + w_bits)
    for n, h, w_, cin, cout, f, s, p in ((2, 11, 9, 5, 20, 3, 1, 1),
                                         (2, 8, 8, 130, 70, 3, 2, 1)):
        x = _ints(rng, a_bits, False, (n, h, w_, cin), dev)
        wpf, cin_pad = _conv_weights(rng, w_bits, f, cin, cout, dev)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, cout, dev)]
        for epi in ("int", "raw", "dequant"):
            got, want = _conv_pair(
                x, wpf, vecs, f=f, s=s, p=p, cin_pad=cin_pad, cout=cout,
                pipeline=pipeline, a_bits=a_bits, a_signed=False,
                w_bits=w_bits, d=23, out_bits=a_bits, epilogue=epi,
                scale=0.013)
            assert _same(got, want)


# (n, h, w, cin, cout, f, stride, padding) the real-channel K order makes
# risky: Cin 1, 3, 160, 200 (two chunks, one ragged), Cout 10, 48, 200, a
# 1x1 stride-2 conv, 5x5 convs, Wo not dividing the 128-pixel tile; and
# the depthwise per-group lowering's cin = cout = 1 3x3 convs at stride 1
# and 2 (one real column of a 16-wide tile, a 1-byte output row)
WALL = ((2, 9, 7, 1, 10, 5, 1, 2), (2, 11, 9, 3, 48, 3, 1, 1),
        (2, 8, 8, 160, 200, 3, 2, 1), (2, 9, 9, 200, 48, 1, 2, 0),
        (1, 7, 13, 3, 200, 5, 1, 2), (2, 8, 8, 1, 1, 3, 1, 1),
        (2, 8, 8, 1, 1, 3, 2, 1))


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qconv_kernel_real_channels_match_plain(dev, a_bits, w_bits,
                                                pipeline):
    rng = np.random.default_rng(a_bits * 10 + w_bits + 1)
    for n, h, w_, cin, cout, f, s, p in WALL:
        x = _ints(rng, a_bits, False, (n, h, w_, cin), dev)
        wpf, cin_pad = _conv_weights(rng, w_bits, f, cin, cout, dev)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, cout, dev)]
        plan = conv_k.conv_k_plan(f, f, cin, a_bits, w_bits,
                                  conv_k.conv_stage_k(cout))
        staged = conv_k.conv_staging(x, plan, a_bits=a_bits,
                                     cin_pad=cin_pad)
        xs = x if staged is None else conv_k.stage_image(x, staged, a_bits)
        for epi in ("int", "raw", "dequant"):
            kw = dict(a_bits=a_bits, a_signed=False, w_bits=w_bits, d=23,
                      out_bits=a_bits, epilogue=epi, scale=0.013)
            got, want = _conv_pair(x, wpf, vecs, f=f, s=s, p=p,
                                   cin_pad=cin_pad, cout=cout,
                                   pipeline=pipeline, **kw)
            assert _same(got, want), ((n, h, w_, cin, cout, f, s, p), epi)
            # the kernel's K order emulated in torch on the card agrees too
            assert _same(conv_k.qconv_k_order_torch(
                xs, wpf, *vecs, fh=f, fw=f, stride=s, padding=p, cin=cin,
                cin_pad=cin_pad, cout=cout, **kw), want)


# (h, w, cin, cout, f, stride, padding) of ResNet-8's nine convs: stem,
# s1/c1, s1/c2, s2/c1, s2/c2, s2/skip, s3/c1, s3/c2, s3/skip
RESNET8_CONVS = ((32, 32, 3, 16, 3, 1, 1), (32, 32, 16, 16, 3, 1, 1),
                 (32, 32, 16, 16, 3, 1, 1), (32, 32, 16, 32, 3, 2, 1),
                 (16, 16, 32, 32, 3, 1, 1), (32, 32, 16, 32, 1, 2, 0),
                 (16, 16, 32, 64, 3, 2, 1), (8, 8, 64, 64, 3, 1, 1),
                 (16, 16, 32, 64, 1, 2, 0))


@pytest.mark.parametrize("batch", [1, 7, 300])
@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("w_bits", [8, 4])
def test_qconv_kernel_resnet8_shapes_unpadded_match_plain(dev, w_bits,
                                                          pipeline, batch):
    """ResNet-8's conv shapes on unpadded images, W8A8 and W4A8: bit for
    bit the plain version; only the stem's image is copied (3 -> 4
    channels), the other eight are read where they lie."""
    from repro_torch.obs import trace as obs
    rng = np.random.default_rng(w_bits * 1000 + batch)
    with obs.enabled_scope():
        obs.reset()
        for h, w_, cin, cout, f, s, p in RESNET8_CONVS:
            x = _ints(rng, 8, False, (batch, h, w_, cin), dev)
            wpf, cin_pad = _conv_weights(rng, w_bits, f, cin, cout, dev)
            vecs = [v.to(dev) for v in _epilogue_vectors(rng, cout, dev)]
            got, want = _conv_pair(
                x, wpf, vecs, f=f, s=s, p=p, cin_pad=cin_pad, cout=cout,
                pipeline=pipeline, a_bits=8, a_signed=False, w_bits=w_bits,
                d=23, out_bits=8, epilogue="int", scale=1.0)
            assert _same(got, want), (batch, h, w_, cin, cout, f, s, p)
        staged = obs.counter_values()
        obs.reset()
    assert staged == {"qconv.staged": 1,
                      "qconv.staged_bytes": batch * 32 * 32 * 4}


# (n, h, w, cin, cout, f, stride, padding) whose pixel stride the wrapper
# widens (Cin 12 -> 16, 130 -> 144, 200 -> 208; sub-byte to cin_pad) or
# reads as it is (Cin 16) at padding 0, 1 and 2 and strides 1 and 2
UNPADDED = ((2, 8, 8, 130, 70, 3, 2, 1), (2, 9, 9, 200, 48, 1, 2, 0),
            (1, 7, 7, 200, 16, 3, 2, 1), (2, 6, 7, 12, 20, 3, 1, 1),
            (2, 9, 8, 16, 32, 3, 2, 0), (1, 6, 5, 130, 24, 3, 1, 2))


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qconv_kernel_unpadded_strides_match_plain(dev, a_bits, w_bits,
                                                   pipeline):
    """The kernel's border and pixel strides at every width pair: ragged
    and wide Cin, a per-group depthwise slice (a non-contiguous cin = 1
    view of a wider image) and an image off the 16-byte grid."""
    rng = np.random.default_rng(a_bits * 10 + w_bits + 5)
    kw = dict(a_bits=a_bits, a_signed=False, w_bits=w_bits, d=23,
              out_bits=a_bits, epilogue="int", scale=1.0)
    for n, h, w_, cin, cout, f, s, p in UNPADDED:
        x = _ints(rng, a_bits, False, (n, h, w_, cin), dev)
        wpf, cin_pad = _conv_weights(rng, w_bits, f, cin, cout, dev)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, cout, dev)]
        got, want = _conv_pair(x, wpf, vecs, f=f, s=s, p=p, cin_pad=cin_pad,
                               cout=cout, pipeline=pipeline, **kw)
        assert _same(got, want), (n, h, w_, cin, cout, f, s, p)
    wide = _ints(rng, a_bits, False, (2, 8, 8, 5), dev)
    wpf, cin_pad = _conv_weights(rng, w_bits, 3, 1, 1, dev)
    vecs = [v.to(dev) for v in _epilogue_vectors(rng, 1, dev)]
    for s in (1, 2):
        got, want = _conv_pair(wide[..., 2:3], wpf, vecs, f=3, s=s, p=1,
                               cin_pad=cin_pad, cout=1, pipeline=pipeline,
                               **kw)
        assert _same(got, want), ("per_group slice", s)
    buf = _ints(rng, a_bits, False, (2 * 8 * 8 * 16 + 16,), dev)
    x = buf[4:4 + 2 * 8 * 8 * 16].view(2, 8, 8, 16)
    wpf, cin_pad = _conv_weights(rng, w_bits, 3, 16, 32, dev)
    vecs = [v.to(dev) for v in _epilogue_vectors(rng, 32, dev)]
    got, want = _conv_pair(x, wpf, vecs, f=3, s=1, p=1, cin_pad=cin_pad,
                           cout=32, pipeline=pipeline, **kw)
    assert _same(got, want), "misaligned"


def test_resnet8_on_the_card_matches_cpu(dev):
    from repro_torch.convert import to_device
    from repro_torch.vision import models
    from repro_torch.vision.configs import get_vision_config

    cfg = get_vision_config("resnet8", smoke=True)
    fp = models.init_fp(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    absmax = models.collect_absmax(cfg, fp, [rng.uniform(
        0, 1, (4, *cfg.in_hw, 3)).astype(np.float32)])
    qnet = models.quantize_net(cfg, fp, absmax, device=dev)
    imgs = rng.uniform(0, 1, (5, *cfg.in_hw, 3))
    got = models.forward_int(qnet, models.quantize_input(qnet, imgs))
    cpu = to_device(qnet, "cpu")
    want = models.forward_int(cpu, models.quantize_input(cpu, imgs))
    assert torch.equal(got.cpu(), want)


def _card_and_cpu_nets(name, dev, w_bits):
    """A seeded smoke net quantized on the card at uniform ``w_bits``, its
    CPU copy and seeded images."""
    from repro_torch.convert import to_device
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.vision import models
    from repro_torch.vision.configs import get_vision_config

    cfg = get_vision_config(name, smoke=True)
    fp = models.init_fp(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    absmax = models.collect_absmax(cfg, fp, [rng.uniform(
        0, 1, (4, *cfg.in_hw, 3)).astype(np.float32)])
    qnet = models.quantize_net(cfg, fp, absmax, device=dev,
                               plan=uniform_plan(cfg, w_bits, cfg.a_bits))
    return qnet, to_device(qnet, "cpu"), rng.uniform(0, 1,
                                                     (5, *cfg.in_hw, 3))


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_mobilenet_on_the_card_matches_cpu(dev, w_bits):
    from repro_torch.vision import models

    qnet, cpu, imgs = _card_and_cpu_nets("mobilenet-tiny", dev, w_bits)
    want = models.forward_int(cpu, models.quantize_input(cpu, imgs))
    x = models.quantize_input(qnet, imgs)
    for lowering in ("auto", "qdot", "per_group"):
        for pipeline in ("off", "double_buffer"):
            got = models.forward_int(qnet, x, lowering=lowering,
                                     pipeline=pipeline)
            assert torch.equal(got.cpu(), want), (lowering, pipeline)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_depthwise_lowerings_on_the_card_match_cpu(dev, a_bits, w_bits,
                                                   pipeline):
    from repro_torch.convert import to_device
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.vision.layers import quantize_depthwise

    rng = np.random.default_rng(a_bits * 10 + w_bits + 3)
    for c, stride in itertools.product((16, 32, 64), (1, 2)):
        p = {"w": rng.normal(size=(3, 3, c)).astype(np.float32),
             "bn_scale": (rng.normal(size=(c,)) * 0.05 + 0.4).astype(
                 np.float32),
             "bn_bias": (rng.normal(size=(c,)) * 0.02).astype(np.float32)}
        dw = quantize_depthwise(
            {k: torch.from_numpy(v).to(dev) for k, v in p.items()},
            QuantSpec.activation(a_bits, 2.0),
            QuantSpec.activation(a_bits, 1.5), w_bits, stride=stride,
            padding=1)
        x = _ints(rng, a_bits, False, (3, 8, 8, c), dev)
        want = to_device(dw, "cpu").apply(x.cpu(), lowering="qdot")
        for lowering in ("qdot", "per_group"):
            got = dw.apply(x, lowering=lowering, pipeline=pipeline)
            assert torch.equal(got.cpu(), want), (c, stride, lowering)


MIXES = ((8, 4), (8, 2), (4, 2), (8, 4, 2))


def _mix_runs(widths, n):
    runs, pos = [], 0
    for i, b in enumerate(widths):
        end = n if i == len(widths) - 1 else pos + packing.CHUNK
        runs.append((pos, end, b))
        pos = end
    return packing.SegmentMap(tuple(runs))


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits", [8, 4, 2])
def test_qmatmul_segmented_kernel_matches_plain(dev, a_bits, pipeline):
    from repro_torch.core.quantize import quantize_linear_segmented
    from repro_torch.kernels import api

    rng = np.random.default_rng(a_bits)
    # K not a CHUNK multiple (split across blocks at these M), M past one
    # tile, N with a ragged tail; then a ragged last run at W8
    cases = [((100, 200, 320), _mix_runs(widths, 320)) for widths in MIXES]
    cases.append(((40, 200, 200),
                  packing.SegmentMap(((0, 128, 2), (128, 200, 8)))))
    for (m, k, n), segmap in cases:
        widths = tuple(b for _, _, b in segmap.runs)
        w = torch.cat([_ints(rng, b, True, (k, e - s), dev)
                       for s, e, b in segmap.runs], dim=1)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, n, dev)]
        params = quantize_linear_segmented(w, segmap, *vecs, a_bits=a_bits,
                                           a_signed=False, d=23,
                                           out_bits=a_bits,
                                           assert_range=True)
        xp = packing.pack(packing.pad_to_chunk(
            _ints(rng, a_bits, False, (m, k), dev)), a_bits)
        w_flat, padded = packing.pad_segmented(params.w_flat, segmap, k)
        pvecs = [torch.nn.functional.pad(v, (0, padded.n - n))
                 for v in vecs]
        scale = torch.from_numpy(rng.uniform(1e-3, 1e-1, padded.n).astype(
            np.float32)).to(dev)
        for epi, sc in (("int", 1.0), ("raw", 1.0), ("dequant", 0.013),
                        ("dequant", scale)):
            kw = dict(k_logical=k, a_bits=a_bits, a_signed=False, d=23,
                      out_bits=a_bits, epilogue=epi, scale=sc)
            before = gemm_k.SEGMENTED_KERNEL.launches[
                1 if pipeline == "off" else 2]
            got = gemm_k.qmatmul_segmented_cuda(xp, w_flat, padded, *pvecs,
                                                pipeline=pipeline, **kw)
            assert gemm_k.SEGMENTED_KERNEL.launches[
                1 if pipeline == "off" else 2] == before + 1
            assert _same(got, gemm_k.qmatmul_segmented_torch(
                xp, w_flat, padded, *pvecs, **kw)), (widths, epi)
        # the public entry point pads, launches and slices back to N
        got = api.qdot_packed(params, xp, pipeline=pipeline)
        assert got.shape == (m, n)
        assert torch.equal(got, api.qdot_packed(
            convert_to_cpu(params), xp.cpu()).to(dev))


def convert_to_cpu(obj):
    from repro_torch.convert import to_device
    return to_device(obj, "cpu")


def test_qat_cnn_plan_a_on_the_card_matches_cpu(dev):
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.vision import models
    from repro_torch.vision.configs import get_vision_config

    cfg = get_vision_config("qat-cnn")
    plan = PrecisionPlan(rules=(PlanRule(
        pattern="c3", w_bits=8, segments=((0, 128, 8), (128, 256, 4))),))
    fp = models.init_fp(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    absmax = models.collect_absmax(cfg, fp, [rng.uniform(
        0, 1, (8, 16, 16, 1)).astype(np.float32)])
    qnet = models.quantize_net(cfg, fp, absmax, plan=plan, device=dev)
    imgs = rng.uniform(0, 1, (5, 16, 16, 1))
    got = models.forward_int(qnet, models.quantize_input(qnet, imgs))
    cpu = models.quantize_net(cfg, convert_to_cpu(fp), absmax, plan=plan,
                              device="cpu")
    want = models.forward_int(cpu, models.quantize_input(cpu, imgs))
    assert torch.equal(got.cpu(), want)


def test_tuned_launch_matches_planned_and_tune_times_the_device(dev):
    """A GEMM with many valid launches (fig8, 16 K stages, the 128-wide
    tile at A8): each launch at both pipelines gives the planned launch's
    output; `autotune_qdot` ranks by device time, and the api then takes
    the tuned launch and pipeline without moving the result."""
    from repro_torch import obs as obs_pkg
    from repro_torch.kernels import api, tune
    from repro_torch.obs import trace as obs

    gen = torch.Generator().manual_seed(7)
    m, k, n = 256, 2048, 256
    params, xp = tune._mk_qdot_artifact(gen, m, k, n, 8, 4, dev)
    launches = gemm_k.gemm_launches(m, n, k, 8, gemm_k.sm_count(dev))
    assert len(launches) == 16
    tune.clear()
    obs_pkg.reset()
    try:
        want = api.qdot_run(params, xp, epilogue="raw", scale=1.0,
                            pipeline="off")
        for pipeline in ("off", "double_buffer"):
            for L in launches:
                got = api.qdot_run(
                    params, xp, epilogue="raw", scale=1.0, pipeline=pipeline,
                    launch={"splits": L.splits, "min_blocks": L.min_blocks})
                assert torch.equal(got, want), (pipeline, L)
        with pytest.raises(ValueError, match="splits=9"):
            api.qdot_run(params, xp, epilogue="raw", scale=1.0,
                         pipeline="off",
                         launch={"splits": 9, "min_blocks": 1})
        with obs.enabled_scope():
            launch, pipe = tune.autotune_qdot(params, xp, epilogue="raw",
                                              iters=3)
            (sweep,) = obs.spans("tune.sweep")
        assert sweep["args"]["exact"] is True
        assert sweep["args"]["candidates"] == 32
        e = tune.get_entry("qdot", (m, k, n), 8, 4, "cuda")
        assert e["timer"] == "device" and e["us"] > 0
        assert (e["launch"], e["pipeline"]) == (launch, pipe)
        with obs.enabled_scope():
            got = api.qdot_packed(params, xp, epilogue="raw")
            (ev,) = obs.dispatch_log()
        assert ev["launch_source"] == "tuned" and ev["launch"] == launch
        assert ev["pipeline_source"] == "tuned"
        assert torch.equal(got, want)
    finally:
        tune.clear()
        obs_pkg.reset()


# The LM dense path's operands: signed activation codes, a per-channel
# dequant scale and both output dtypes, at qwen2.5-3b's K x N shapes
# (narrowed where N is wide) and M of a decode step, a batch and a
# ragged prefill
DENSE_SHAPES = ((1, 2048, 256), (4, 2048, 384), (64, 11008, 128),
                (37, 200, 100))


def _dense_vectors(rng, n, dev):
    return torch.from_numpy(rng.uniform(1e-4, 1e-2, n).astype(
        np.float32)).to(dev)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qmatmul_signed_vector_scale_f32_matches_plain(dev, a_bits, w_bits,
                                                       pipeline):
    rng = np.random.default_rng(a_bits * 10 + w_bits + 5)
    for m, k, n in DENSE_SHAPES:
        x = packing.pack(packing.pad_to_chunk(
            _ints(rng, a_bits, True, (m, k), dev)), a_bits)
        w = packing.pack(packing.pad_to_chunk(
            _ints(rng, w_bits, True, (k, n), dev), axis=0), w_bits, axis=0)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, n, dev)]
        scale = _dense_vectors(rng, n, dev)
        cases = [("int", None, vecs), ("raw", None, [None] * 3)] + [
            ("dequant", dt, [None] * 3)
            for dt in (torch.bfloat16, torch.float32)]
        for epi, out_dtype, v in cases:
            kw = dict(a_bits=a_bits, a_signed=True, w_bits=w_bits, d=23,
                      out_bits=a_bits, epilogue=epi, scale=scale,
                      k_logical=k, out_dtype=out_dtype)
            want = gemm_k.qmatmul_packed_torch(x, w, *v, **kw)
            got = gemm_k.qmatmul_packed_cuda(x, w, *v, pipeline=pipeline,
                                             **kw)
            assert got.dtype == want.dtype
            assert _same(got, want), ((m, k, n), epi, out_dtype)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits", [8, 4, 2])
def test_qmatmul_segmented_signed_f32_matches_plain(dev, a_bits, pipeline):
    rng = np.random.default_rng(a_bits + 7)
    for (m, k, n), segmap in (
            ((4, 2048, 512), packing.SegmentMap(((0, 256, 8),
                                                 (256, 512, 4)))),
            ((37, 200, 320), _mix_runs((8, 4, 2), 320))):
        w = torch.cat([_ints(rng, b, True, (k, e - s), dev)
                       for s, e, b in segmap.runs], dim=1)
        w_flat, padded = packing.pad_segmented(
            packing.pack_segmented(w, segmap), segmap, k)
        xp = packing.pack(packing.pad_to_chunk(
            _ints(rng, a_bits, True, (m, k), dev)), a_bits)
        scale = _dense_vectors(rng, padded.n, dev)
        for out_dtype in (torch.bfloat16, torch.float32):
            kw = dict(k_logical=k, a_bits=a_bits, a_signed=True, d=0,
                      out_bits=8, epilogue="dequant", scale=scale,
                      out_dtype=out_dtype)
            want = gemm_k.qmatmul_segmented_torch(xp, w_flat, padded,
                                                  None, None, None, **kw)
            got = gemm_k.qmatmul_segmented_cuda(xp, w_flat, padded, None,
                                                None, None,
                                                pipeline=pipeline, **kw)
            assert got.dtype == out_dtype
            assert _same(got, want), ((m, k, n), out_dtype)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_layer_on_the_card_matches_cpu(dev, dtype, segmented):
    from repro_torch.nn import layers

    rng = np.random.default_rng(11)
    segments = ((0, 128, 8), (128, 300, 4)) if segmented else None
    w = torch.from_numpy((rng.normal(size=(200, 300)) * 0.1).astype(
        np.float32))
    for a_bits in (8, 4, 2):
        qcfg = layers.QuantConfig(mode="int", w_bits=8 if segmented else 4,
                                  a_bits=a_bits, segments=segments)
        pk, sc = (layers.pack_dense_weights_segmented(w, segments)
                  if segmented else layers.pack_dense_weights(w, 4))
        p = {"w_packed": pk, "w_scale": sc,
             "b": torch.from_numpy(rng.normal(size=300).astype(np.float32))}
        x = torch.from_numpy((rng.normal(size=(3, 5, 200)) * 2).astype(
            np.float32)).to(dtype)
        want = layers.dense_apply(p, x, qcfg=qcfg)
        got = layers.dense_apply({k: v.to(dev) for k, v in p.items()},
                                 x.to(dev), qcfg=qcfg)
        assert got.dtype == dtype and _same(got.cpu(), want)


def test_bfloat16_weight_scale_dense_on_the_card_matches_cpu(dev):
    # a bfloat16 param tree (llama-3.2-vision's) packs a bfloat16 w_scale;
    # the dequant scale must round the same way on both devices
    from repro_torch.nn import layers

    rng = np.random.default_rng(12)
    w = torch.from_numpy((rng.normal(size=(512, 300)) * 0.05).astype(
        np.float32)).to(torch.bfloat16)
    pk, sc = layers.pack_dense_weights(w, 4)
    assert sc.dtype == torch.bfloat16
    qcfg = layers.QuantConfig(mode="int", w_bits=4, a_bits=8)
    x = torch.from_numpy(rng.normal(size=(4, 1, 512)).astype(
        np.float32)).to(torch.bfloat16)
    want = layers.dense_apply({"w_packed": pk, "w_scale": sc}, x, qcfg=qcfg)
    got = layers.dense_apply({"w_packed": pk.to(dev), "w_scale": sc.to(dev)},
                             x.to(dev), qcfg=qcfg)
    assert _same(got.cpu(), want)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qconv_signed_vector_scale_matches_plain(dev, a_bits, w_bits,
                                                 pipeline):
    # the conv's sign-extending activation unpack and a per-channel
    # dequant scale, which no served net reaches
    rng = np.random.default_rng(a_bits * 10 + w_bits + 9)
    for n, h, w_, cin, cout, f, s, p in WALL[:4]:
        x = _ints(rng, a_bits, True, (n, h, w_, cin), dev)
        wpf, cin_pad = _conv_weights(rng, w_bits, f, cin, cout, dev)
        vecs = [v.to(dev) for v in _epilogue_vectors(rng, cout, dev)]
        for epi in ("int", "raw", "dequant"):
            got, want = _conv_pair(
                x, wpf, vecs, f=f, s=s, p=p, cin_pad=cin_pad, cout=cout,
                pipeline=pipeline, a_bits=a_bits, a_signed=True,
                w_bits=w_bits, d=23, out_bits=a_bits, epilogue=epi,
                scale=_dense_vectors(rng, cout, dev))
            assert _same(got, want), ((n, h, w_, cin, cout, f, s, p), epi)


def _smoke_w4a8(arch, dev):
    """(model, params on the CPU, params on ``dev``) of an arch's smoke
    config at W4A8, packed on the CPU from seeded fp weights."""
    import dataclasses

    from repro_torch.convert import to_device
    from repro_torch.launch.convert import convert_params
    from repro_torch.models import api
    from repro_torch.nn import layers

    cfg = api.get_smoke_config(arch)
    fp = api.build(cfg).init(0, device="cpu")
    model = api.build(dataclasses.replace(cfg, quant=layers.QuantConfig(
        mode="int", w_bits=4, a_bits=8)))
    q = convert_params(model.init(0, device="cpu"), fp, 4)
    return model, q, to_device(q, dev)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_decode_dense_calls_on_the_card_match_cpu(dev, arch):
    # one W4A8 decode step at per-slot positions, past the rgemma-smoke
    # ring's wrap (window 8): every dense call on the card is identical
    # to the same call on the CPU
    from repro_torch.convert import to_device
    from repro_torch.nn import layers

    model, _, q = _smoke_w4a8(arch, dev)
    cache = model.init_cache(3, 32, device=dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        2, 128, (3, 12))).to(dev)
    for t in range(11):
        model.decode(q, cache, toks[:, t:t + 1], t)
    calls = []
    with layers.dense_tap(lambda p, x: calls.append((p, x))):
        model.decode(q, cache, toks[:, 11:], torch.tensor([11, 9, 10],
                                                          device=dev))
    # smoke depth: 2 mamba layers x 2; 6 rec layers x 8 + 2 attention x 7
    assert len(calls) == {"mamba2-370m": 2 * 2,
                          "recurrentgemma-9b": 6 * 8 + 2 * 7}[arch]
    for p, x in calls:
        got = layers.dense_apply(p, x, qcfg=model.cfg.quant)
        want = layers.dense_apply(to_device(p, "cpu"), x.cpu(),
                                  qcfg=model.cfg.quant)
        assert _same(got.cpu(), want)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_ring_cache_decode_on_the_card_matches_cpu(dev, vector):
    # rgemma-smoke W4A8 over 20 steps on an 8-slot ring, float32 compute:
    # the card's logits within 1e-3 of the largest of the CPU's
    import dataclasses

    model, q_cpu, q = _smoke_w4a8("recurrentgemma-9b", dev)
    model = dataclasses.replace(model, cfg=dataclasses.replace(
        model.cfg, compute_dtype="float32"))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        2, 128, (2, 20)))
    caches = {d: model.init_cache(2, 64, torch.float32, device=d)
              for d in ("cpu", dev)}
    assert caches["cpu"]["kv"]["k"].shape[2] == 8
    for t in range(20):
        idx = torch.tensor([t, max(t - 3, 0)]) if vector else t
        want, _ = model.decode(q_cpu, caches["cpu"], toks[:, t:t + 1], idx)
        got, _ = model.decode(q, caches[dev], toks[:, t:t + 1].to(dev),
                              idx.to(dev) if vector else idx)
        tol = 1e-3 * float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= tol, t


def test_reset_state_zeroes_only_the_masked_slots_on_the_card(dev):
    from repro_torch.serve.runtime.adapters import LMDecodeAdapter

    for arch in ("mamba2-370m", "recurrentgemma-9b"):
        model, _, q = _smoke_w4a8(arch, dev)
        adapter = LMDecodeAdapter(model, q, 16)
        cache = adapter.init_state(4)
        for tree in cache.values():
            for leaf in tree.values():
                leaf.fill_(1)
        assert adapter.reset_state(
            cache, np.array([True, False, False, True])) is cache
        for name, tree in cache.items():
            for leaf in tree.values():
                assert leaf.device.type == "cuda"
                cleared = name in ("ssm", "rec")
                assert bool((leaf[:, [0, 3]] == 0).all()) == cleared
                assert bool((leaf[:, [1, 2]] == 1).all())


# (M, K, N) of the cross-attention archs' denses (chip_smoke.py's [xattn]
# wall): seamless-m4t-large-v2's at a decode step (M = 4) and over its
# encoder's 4 x 4096 frames (M = 16,384), llama-3.2-vision-90b's at M = 4
# and its cross K/V projection over 4096 source positions
XATTN_SHAPES = tuple(
    (m, k, n) for m in (4, 16384)
    for k, n in ((1024, 1024), (1024, 8192), (8192, 1024))) + tuple(
    (4, k, n) for k, n in ((8192, 8192), (8192, 1024), (8192, 28672),
                           (28672, 8192))) + ((4096, 8192, 1024),)


def _dev_ints(gen, bits, shape):
    lo, hi = packing.int_range(bits, True)
    return torch.randint(-hi if bits == 8 else lo, hi + 1, shape,
                         generator=gen, device=gen.device,
                         dtype=torch.int32).to(torch.int8)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_qmatmul_cross_attention_shapes_match_plain(dev, w_bits, pipeline):
    gen = torch.Generator(device=dev).manual_seed(w_bits)
    for m, k, n in XATTN_SHAPES:
        x = packing.pack(_dev_ints(gen, 8, (m, k)), 8)
        w = packing.pack(_dev_ints(gen, w_bits, (k, n)), w_bits, axis=0)
        scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-5
        for out_dtype in (torch.bfloat16, torch.float32):
            kw = dict(a_bits=8, a_signed=True, w_bits=w_bits, d=0,
                      out_bits=8, epilogue="dequant", scale=scale,
                      k_logical=k, out_dtype=out_dtype)
            want = gemm_k.qmatmul_packed_torch(x, w, None, None, None, **kw)
            got = gemm_k.qmatmul_packed_cuda(x, w, None, None, None,
                                             pipeline=pipeline, **kw)
            assert got.dtype == out_dtype
            assert _same(got, want), ((m, k, n), out_dtype)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
def test_qmatmul_segmented_cross_attention_plan_matches_plain(dev,
                                                              pipeline):
    # seamless's dec_layers/mlp/wi split W8 | W4, at a decode step and
    # over the encoder's rows
    gen = torch.Generator(device=dev).manual_seed(3)
    k = 1024
    segmap = packing.SegmentMap(((0, 4096, 8), (4096, 8192, 4)))
    w = torch.cat([_dev_ints(gen, b, (k, e - s)) for s, e, b in segmap.runs],
                  dim=1)
    w_flat, padded = packing.pad_segmented(
        packing.pack_segmented(w, segmap), segmap, k)
    scale = torch.rand(padded.n, generator=gen, device=dev) * 1e-3 + 1e-5
    for m, a_bits in ((4, 8), (4, 4), (4, 2), (16384, 8)):
        xp = packing.pack(_dev_ints(gen, a_bits, (m, k)), a_bits)
        for out_dtype in (torch.bfloat16, torch.float32):
            kw = dict(k_logical=k, a_bits=a_bits, a_signed=True, d=0,
                      out_bits=8, epilogue="dequant", scale=scale,
                      out_dtype=out_dtype)
            want = gemm_k.qmatmul_segmented_torch(xp, w_flat, padded, None,
                                                  None, None, **kw)
            got = gemm_k.qmatmul_segmented_cuda(xp, w_flat, padded, None,
                                                None, None,
                                                pipeline=pipeline, **kw)
            assert _same(got, want), (m, a_bits, out_dtype)


def _filled_cache(model, q, batch, max_len, dev, dtype=torch.bfloat16):
    src = torch.from_numpy((np.random.default_rng(8).normal(size=(
        batch, model.cfg.src_len, model.cfg.d_model)) * 0.5).astype(
        np.float32)).to(dev)
    return model.fill_cross_kv(q, model.init_cache(batch, max_len, dtype,
                                                   device=dev), src)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_cross_attention_decode_dense_calls_on_the_card_match_cpu(dev, arch):
    # one W4A8 decode step at per-slot positions over a cross cache filled
    # from the source: every int dense call on the card is identical to
    # the same call on the CPU
    from repro_torch.convert import to_device
    from repro_torch.nn import layers

    model, _, q = _smoke_w4a8(arch, dev)
    cache = _filled_cache(model, q, 3, 32, dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        2, 128, (3, 12))).to(dev)
    for t in range(11):
        model.decode(q, cache, toks[:, t:t + 1], t)
    calls = []
    with layers.dense_tap(lambda p, x: calls.append((p, x))
                          if "w_packed" in p else None):
        model.decode(q, cache, toks[:, 11:], torch.tensor([11, 9, 10],
                                                          device=dev))
    # smoke depth: seamless 2 decoder layers x (4 self + wq, wo + 2 mlp);
    # vision 4 self layers x 7 + 1 cross layer x (wq, wo + 3 mlp)
    assert len(calls) == {"seamless-m4t-large-v2": 2 * 8,
                          "llama-3.2-vision-90b": 4 * 7 + 5}[arch]
    for p, x in calls:
        got = layers.dense_apply(p, x, qcfg=model.cfg.quant)
        want = layers.dense_apply(to_device(p, "cpu"), x.cpu(),
                                  qcfg=model.cfg.quant)
        assert _same(got.cpu(), want)


def test_encdec_forward_and_decode_on_the_card_match_cpu(dev):
    # seamless-smoke W4A8, float32 compute: the forward and 12 decode steps
    # over the cross cache each device fills from `encode`, the card's
    # logits within 1e-3 of the largest of the CPU's
    import dataclasses

    model, q_cpu, q = _smoke_w4a8("seamless-m4t-large-v2", dev)
    model = dataclasses.replace(model, cfg=dataclasses.replace(
        model.cfg, compute_dtype="float32"))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        2, 128, (2, 12)))
    src = torch.from_numpy((np.random.default_rng(7).normal(size=(
        2, 16, 64)) * 0.5).astype(np.float32))
    want, _, _ = model.forward(q_cpu, {"tokens": toks, "src_embed": src})
    got, _, _ = model.forward(q, {"tokens": toks.to(dev),
                                  "src_embed": src.to(dev)})
    tol = 1e-3 * float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= tol
    caches = {"cpu": _filled_cache(model, q_cpu, 2, 12, "cpu",
                                   torch.float32),
              dev: _filled_cache(model, q, 2, 12, dev, torch.float32)}
    for t in range(12):
        want, _ = model.decode(q_cpu, caches["cpu"], toks[:, t:t + 1], t)
        got, _ = model.decode(q, caches[dev], toks[:, t:t + 1].to(dev), t)
        assert float((got.cpu() - want).abs().max()) <= tol, t


# (K, N) of the MoE archs' int denses (chip_smoke.py's [moe] wall), at a
# decode step of the served batch (M = 4): kimi-k2-1t-a32b's wq / wo
# (7168x7168), wk / wv (7168x896), shared wi / wg (7168x2048) and shared
# wo (2048x7168); llama4-maverick-400b-a17b's 5120x5120, 5120x1024,
# 5120x8192 and 8192x5120
MOE_SHAPES = ((7168, 7168), (7168, 896), (7168, 2048), (2048, 7168),
              (5120, 5120), (5120, 1024), (5120, 8192), (8192, 5120))


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_qmatmul_moe_shapes_match_plain(dev, w_bits, pipeline):
    gen = torch.Generator(device=dev).manual_seed(20 + w_bits)
    for k, n in MOE_SHAPES:
        x = packing.pack(_dev_ints(gen, 8, (4, k)), 8)
        w = packing.pack(_dev_ints(gen, w_bits, (k, n)), w_bits, axis=0)
        scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-5
        for out_dtype in (torch.bfloat16, torch.float32):
            kw = dict(a_bits=8, a_signed=True, w_bits=w_bits, d=0,
                      out_bits=8, epilogue="dequant", scale=scale,
                      k_logical=k, out_dtype=out_dtype)
            want = gemm_k.qmatmul_packed_torch(x, w, None, None, None, **kw)
            got = gemm_k.qmatmul_packed_cuda(x, w, None, None, None,
                                             pipeline=pipeline, **kw)
            assert got.dtype == out_dtype
            assert _same(got, want), ((k, n), out_dtype)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("w_bits", [8, 4])
def test_qmatmul_grouped_matches_each_group_plain(dev, w_bits, pipeline):
    """kimi-k2-instruct's held experts: row groups of 341, 0, 130, 512
    and 1 rows against their own weights (K 7168 -> N 2048, K 2048 -> N
    7168 with a ragged K 2000 zero-padded, as the dense layer pads it),
    each group's rows equal to the plain version's on them, bf16 and
    float32 out."""
    gen = torch.Generator(device=dev).manual_seed(40 + w_bits)
    counts = [341, 0, 130, 512, 1]
    for k, n, k_logical in ((7168, 2048, 7168), (2048, 7168, 2000)):
        xi = _dev_ints(gen, 8, (sum(counts), k))
        xi[:, k_logical:] = 0
        x = packing.pack(xi, 8)
        ws = [_dev_ints(gen, w_bits, (k, n)) for _ in counts]
        for wi in ws:
            wi[k_logical:] = 0
        w = torch.stack([packing.pack(wi, w_bits, axis=0) for wi in ws])
        scale = torch.rand(len(counts), n, generator=gen,
                           device=dev) * 1e-3 + 1e-5
        for out_dtype in (torch.bfloat16, torch.float32):
            got = gemm_k.qmatmul_grouped(
                x, w, scale, counts, a_bits=8, w_bits=w_bits,
                pipeline=pipeline, k_logical=k_logical, out_dtype=out_dtype)
            start = 0
            for e, c in enumerate(counts):
                want = gemm_k.qmatmul_packed_torch(
                    x[start:start + c], w[e], None, None, None, a_bits=8,
                    a_signed=True, w_bits=w_bits, d=0, out_bits=8,
                    epilogue="dequant", scale=scale[e], k_logical=k_logical,
                    out_dtype=out_dtype)
                assert _same(got[start:start + c], want), (k, e, out_dtype)
                start += c


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("k,n", [(7168, 2048), (5120, 8192)])
def test_qmatmul_segmented_moe_shared_plan_matches_plain(dev, k, n,
                                                         pipeline):
    # a layers/moe/shared/wi split W8 | W4 at a decode step, A{8,4,2}
    gen = torch.Generator(device=dev).manual_seed(k + n)
    segmap = packing.SegmentMap(((0, n // 2, 8), (n // 2, n, 4)))
    w = torch.cat([_dev_ints(gen, b, (k, e - s)) for s, e, b in segmap.runs],
                  dim=1)
    w_flat, padded = packing.pad_segmented(
        packing.pack_segmented(w, segmap), segmap, k)
    scale = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-5
    for a_bits in (8, 4, 2):
        xp = packing.pack(_dev_ints(gen, a_bits, (4, k)), a_bits)
        for out_dtype in (torch.bfloat16, torch.float32):
            kw = dict(k_logical=k, a_bits=a_bits, a_signed=True, d=0,
                      out_bits=8, epilogue="dequant", scale=scale,
                      out_dtype=out_dtype)
            want = gemm_k.qmatmul_segmented_torch(xp, w_flat, padded, None,
                                                  None, None, **kw)
            got = gemm_k.qmatmul_segmented_cuda(xp, w_flat, padded, None,
                                                None, None,
                                                pipeline=pipeline, **kw)
            assert _same(got, want), (a_bits, out_dtype)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_apply_on_the_card_matches_cpu(dev, arch):
    # the smoke MoE block in float32 with capacity drops (64 tokens,
    # capacity 5): routing identical, y within 1e-5, aux within 1e-6
    import dataclasses

    from repro_torch.convert import to_device
    from repro_torch.models import api, lm
    from repro_torch.nn import mlp
    from repro_torch.nn.module import init_params

    cfg = dataclasses.replace(lm._moe_cfg(api.get_smoke_config(arch)),
                              capacity_factor=0.25)
    p = init_params(mlp.moe_def(cfg), 3, "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    want_y, want_aux = mlp.moe_apply(p, x, cfg)
    got_y, got_aux = mlp.moe_apply(to_device(p, dev), x.to(dev), cfg)
    route = [mlp.moe_route(x.reshape(1, 64, -1).to(d),
                           p["router"].to(d), cfg) for d in ("cpu", dev)]
    for want, got in zip(route[0][2:], route[1][2:]):
        assert torch.equal(got.cpu(), want)
    assert not route[0][4].all()
    assert float((got_y.cpu() - want_y).abs().max()) <= 1e-5
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_decode_dense_calls_on_the_card_match_cpu(dev, arch):
    # one W4A8 decode step at per-slot positions: every int dense call on
    # the card (4 attention + 3 shared expert per layer) is identical to
    # the same call on the CPU
    from repro_torch.convert import to_device
    from repro_torch.nn import layers

    model, _, q = _smoke_w4a8(arch, dev)
    cache = model.init_cache(3, 16, device=dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        2, 128, (3, 8))).to(dev)
    for t in range(7):
        model.decode(q, cache, toks[:, t:t + 1], t)
    calls = []
    with layers.dense_tap(lambda p, x: calls.append((p, x))):
        model.decode(q, cache, toks[:, 7:], torch.tensor([7, 5, 6],
                                                         device=dev))
    assert len(calls) == 7 * model.cfg.n_layers
    for p, x in calls:
        got = layers.dense_apply(p, x, qcfg=model.cfg.quant)
        want = layers.dense_apply(to_device(p, "cpu"), x.cpu(),
                                  qcfg=model.cfg.quant)
        assert _same(got.cpu(), want)


def test_moe_int_tree_shares_the_fp_expert_storage(dev):
    # packed through the int skeleton on the card, the int tree's router
    # and routed experts are the fp tree's tensors: the same storage
    import dataclasses

    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.models import api
    from repro_torch.nn import layers

    cfg = api.get_smoke_config("kimi-k2-1t-a32b")
    fp = api.build(cfg).init(0, device=dev)
    model = api.build(dataclasses.replace(cfg, quant=layers.QuantConfig(
        mode="int", w_bits=4, a_bits=8)))
    q = apply_plan(int_skeleton(model.defs()), fp, None, 4)
    for name in ("router", "wi", "wg", "wo"):
        a, b = q["layers"]["moe"][name], fp["layers"]["moe"][name]
        assert a.device.type == "cuda" and a.data_ptr() == b.data_ptr()
    assert q["embed"]["table"].data_ptr() == fp["embed"]["table"].data_ptr()
    assert q["layers"]["moe"]["shared"]["wi"]["w_packed"].is_cuda


def test_init_leaf_in_place_gives_the_same_values_on_the_card(dev):
    # the in-place scaling of the float32 draw equals the out-of-place
    # product bit for bit, bfloat16 leaves included
    from repro_torch.nn.module import ParamDef, _init_leaf

    for i, d in enumerate((ParamDef((4, 256, 96), ("e", "d", "f"),
                                    dtype=torch.bfloat16),
                           ParamDef((256, 16), ("d", "e"), scale=0.02),
                           ParamDef((300, 64), ("v", "d"), "embed",
                                    dtype=torch.bfloat16))):
        got = _init_leaf(d, 77 + i, dev)
        x = torch.randn(d.shape, generator=torch.Generator(
            device=dev).manual_seed(77 + i), device=dev)
        scale = d.scale if d.init == "embed" else d.scale / d.shape[-2] ** 0.5
        assert torch.equal(got, (x * scale).to(d.dtype)), d


def test_lm_calibrate_on_the_card_matches_cpu(dev):
    # the smoke qwen in float32: the card's stats within float32
    # rounding of the CPU's (the tolerances of test_torch_deploy_lm.py)
    import dataclasses

    from repro_torch.convert import to_device
    from repro_torch.deploy.calibrate import calibrate
    from repro_torch.models import api

    cfg = dataclasses.replace(api.get_smoke_config("qwen2.5-3b"),
                              compute_dtype="float32")
    model = api.build(cfg)
    fp = model.init(0, device="cpu")
    rng = np.random.default_rng(3)
    batches = [rng.integers(2, cfg.vocab, size=(2, 32)).astype(np.int32)
               for _ in range(2)]
    want = calibrate(model, fp, batches)
    got = calibrate(model, to_device(fp, dev), batches)
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert (g.layers, g.d_in, g.d_out, g.taps) == \
            (w.layers, w.d_in, w.d_out, w.taps)
        assert g.a_absmax == pytest.approx(w.a_absmax, rel=1e-5), path
        for b in (8, 4, 2):
            assert g.sens(b) == pytest.approx(w.sens(b), rel=1e-4), path


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8,
                                   torch.bfloat16])
def test_checkpoint_restores_onto_the_card(dev, dtype, tmp_path):
    from repro_torch.ckpt import checkpoint

    gen = torch.Generator().manual_seed(5)
    x = (torch.randint(-128, 128, (3, 5), generator=gen, dtype=torch.int8)
         if dtype == torch.int8 else
         torch.randn(3, 5, generator=gen).to(dtype))
    checkpoint.save(tmp_path, 2, {"a": {"x": x.to(dev)}})
    got, step = checkpoint.restore(tmp_path)        # default: the card
    assert step == 2 and got["a"]["x"].is_cuda
    assert got["a"]["x"].dtype == dtype and torch.equal(got["a"]["x"].cpu(), x)


def test_deploy_cli_on_the_card_matches_cpu(dev, tmp_path):
    # calibrated and packed on the card; the CPU packs the card's plan
    # from the same checkpoint into the same files
    from repro_torch.ckpt import checkpoint
    from repro_torch.launch import deploy
    from repro_torch.models import api

    fp = api.build(api.get_smoke_config("qwen2.5-3b")).init(0, device=dev)
    checkpoint.save(tmp_path / "ck", 0, {"params": fp})
    common = ["--arch", "qwen2.5-3b", "--smoke", "--ckpt",
              str(tmp_path / "ck")]
    card = deploy.main(common + ["--out", str(tmp_path / "p.json"),
                                 "--artifact", str(tmp_path / "card")])
    cpu = deploy.main(common + ["--device", "cpu", "--from-plan",
                                str(tmp_path / "p.json"), "--out",
                                str(tmp_path / "p2.json"), "--artifact",
                                str(tmp_path / "cpu")])
    assert card["mixed_bytes"] == cpu["mixed_bytes"] < card["w8_bytes"]

    def files(d):
        return {str(f.relative_to(d)): f.read_bytes()
                for f in sorted(d.rglob("*")) if f.is_file()}

    assert files(tmp_path / "card") == files(tmp_path / "cpu")


# ------------------------------------------------------ the mesh path ---

def _mesh_linear(rng, a_bits, w_bits, k, n, dev):
    from repro_torch.core.quantize import QuantizedLinearParams
    kappa, lam, m = (v.to(dev) for v in _epilogue_vectors(rng, n, dev))
    return QuantizedLinearParams(
        w_packed=packing.pack(packing.pad_to_chunk(
            _ints(rng, w_bits, True, (k, n), dev), axis=0), w_bits, axis=0),
        w_bits=w_bits, a_bits=a_bits,
        a_signed=False, kappa=kappa, lam=lam, m=m, d=20, out_bits=a_bits,
        k_logical=k)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qdot_on_a_card_mesh_equals_meshless(dev, a_bits, w_bits, pipeline):
    """Every shard on cuda:0, each on its own stream; run twice (a stream
    race shows as a mismatch at random)."""
    from repro_torch.kernels import api
    from repro_torch.launch.mesh import make_cluster_mesh

    rng = np.random.default_rng(a_bits * 10 + w_bits)
    p = _mesh_linear(rng, a_bits, w_bits, 200, 128, dev)
    for m in (64, 61, 1):
        x = _ints(rng, a_bits, False, (m, 200), dev)
        want = api.qdot(p, x, pipeline=pipeline)
        for s in ((1, 1), (1, 4), (4, 1), (2, 2), (8, 1)):
            mesh = make_cluster_mesh(*s, device=dev)
            for _ in range(2):
                got = api.qdot(p, x, pipeline=pipeline, mesh=mesh)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (m, s)


@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_qconv_on_a_card_mesh_equals_meshless(dev, w_bits, pipeline):
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import api
    from repro_torch.kernels.qconv.ops import quantize_conv
    from repro_torch.launch.mesh import make_cluster_mesh

    rng = np.random.default_rng(w_bits)
    w = torch.from_numpy(rng.normal(size=(3, 3, 24, 32)).astype(
        np.float32) * 0.08).to(dev)
    conv = quantize_conv(
        w, QuantSpec.weight(w_bits, float(w.abs().max())),
        torch.full((32,), 0.3, device=dev), torch.zeros(32, device=dev),
        QuantSpec.activation(8, 4.0), QuantSpec.activation(8, 8.0), 1, 1)
    for b in (8, 5):
        x = _ints(rng, 8, False, (b, 8, 8, 24), dev)
        want = api.qconv(conv, x, pipeline=pipeline)
        for s in ((1, 4), (4, 1), (2, 2), (8, 1)):
            mesh = make_cluster_mesh(*s, device=dev)
            for _ in range(2):
                got = api.qconv(conv, x, pipeline=pipeline, mesh=mesh)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (b, s)


def test_vision_and_lm_engines_on_a_card_mesh_match_meshless(dev):
    import dataclasses

    from repro_torch.launch.convert import convert_params
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.models import api as mapi
    from repro_torch.nn.layers import QuantConfig
    from repro_torch.serve.engine import Engine, Request, VisionEngine
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (collect_absmax, init_fp,
                                           quantize_net)

    rng = np.random.default_rng(0)
    cfg = get_vision_config("resnet8", smoke=True)
    fp = init_fp(cfg, seed=0, device=dev)
    imgs = rng.uniform(0, 1, (11, *cfg.in_hw, 3)).astype(np.float32)
    q = quantize_net(cfg, fp, collect_absmax(cfg, fp, [imgs[:4]]),
                     plan=uniform_plan(cfg, 4, 8), device=dev)
    want = VisionEngine(q, 4, device=dev).run(imgs)
    for s in ((2, 2), (4, 1)):
        eng = VisionEngine(q, 4, device=dev,
                           mesh=make_cluster_mesh(*s, device=dev))
        for _ in range(2):
            np.testing.assert_array_equal(eng.run(imgs), want)
    base = mapi.get_smoke_config("qwen2.5-3b")
    model = mapi.build(dataclasses.replace(
        base, quant=QuantConfig(mode="int", w_bits=4, a_bits=8)))
    params = convert_params(model.init(0, device=dev),
                            mapi.build(base).init(1, device=dev), 4)
    prompts = [rng.integers(2, 128, size=int(n)).astype(np.int32)
               for n in (3, 6, 2, 5, 4)]

    def run(mesh):
        eng = Engine(model, params, 3, 32, device=dev, mesh=mesh)
        return [r.out.tolist() for r in eng.generate(
            [Request(prompt=p, max_new_tokens=6) for p in prompts])]

    want = run(None)
    mesh = make_cluster_mesh(4, 1, device=dev)
    assert run(mesh) == want and run(mesh) == want


def test_collectives_and_restore_on_a_card_mesh(dev, tmp_path):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.ring import (collective_matmul,
                                           ring_decode_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 4, 16), (2, 32, 4, 16), (2, 32, 4, 16)))
    mask = torch.arange(32)[None, :] < torch.tensor([[20], [3]])
    x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32))
    card = make_cluster_mesh(1, 4, device=dev)
    cpu = make_cluster_mesh(1, 4, device="cpu")
    for _ in range(2):
        got = ring_decode_attention(q.to(dev), k.to(dev), v.to(dev),
                                    mask.to(dev), card).cpu()
        torch.testing.assert_close(
            got, ring_decode_attention(q, k, v, mask, cpu), rtol=1e-4,
            atol=1e-5)
        got = collective_matmul(x.to(dev), w.to(dev), card).cpu()
        torch.testing.assert_close(got, collective_matmul(x, w, cpu),
                                   rtol=1e-4, atol=1e-4)
    tree = {"w": torch.from_numpy(rng.normal(size=(8, 12)).astype(
        np.float32))}
    ckpt.save(tmp_path, 0, tree)
    mesh = make_cluster_mesh(2, 2, device=dev)
    got, _ = ckpt.restore(tmp_path, shardings={"w": pm.NamedSharding(
        mesh, pm.P("data", "model"))})
    assert got["w"].device.type == "cuda"
    assert torch.equal(pm.gather(got["w"]).cpu(), tree["w"])


def test_mesh_across_cards_matches_meshless(dev):
    """Positions on every card of the host (skips with fewer than two):
    each kernel instantiation sets its shared-memory attribute on each
    device it launches on, at shapes whose tiles need more than 48 KB."""
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import api
    from repro_torch.kernels.qconv.ops import quantize_conv
    from repro_torch.launch.mesh import make_cluster_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    rng = np.random.default_rng(7)
    for pipeline in ("off", "double_buffer"):
        for m, k, n in ((64, 1024, 256), (4096, 576, 128)):
            p = _mesh_linear(rng, 8, 4, k, n, dev)
            x = _ints(rng, 8, False, (m, k), dev)
            want = api.qdot(p, x, pipeline=pipeline)
            for s in ((2, 2), (4, 1), (1, 4)):
                mesh = make_cluster_mesh(*s, device=dev)
                assert len({str(d) for d in mesh.flat}) > 1
                for _ in range(2):
                    got = api.qdot(p, x, pipeline=pipeline, mesh=mesh)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (m, k, n, s, pipeline)
        w = torch.from_numpy(rng.normal(size=(3, 3, 64, 64)).astype(
            np.float32) * 0.05).to(dev)
        conv = quantize_conv(
            w, QuantSpec.weight(4, float(w.abs().max())),
            torch.full((64,), 0.3, device=dev), torch.zeros(64, device=dev),
            QuantSpec.activation(8, 4.0), QuantSpec.activation(8, 8.0), 1,
            1)
        x = _ints(rng, 8, False, (8, 16, 16, 64), dev)
        want = api.qconv(conv, x, pipeline=pipeline)
        for s in ((2, 2), (4, 1), (1, 4)):
            mesh = make_cluster_mesh(*s, device=dev)
            for _ in range(2):
                got = api.qconv(conv, x, pipeline=pipeline, mesh=mesh)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (s, pipeline)


# ------------------------------------------------- QAT and training ---

@pytest.mark.parametrize("bits", [8, 4, 2])
def test_fakequant_on_the_card_matches_cpu(dev, bits):
    """Values and gradients bit for bit, ties at 0 and beta included
    (beta per element: a scalar's gradient is a sum in another order)."""
    from repro_torch.qat import fakequant as fq
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(3, 3, 16, 256)).astype(np.float32)
    w[0, 0, 0, 0] = np.abs(w).max()
    x = rng.uniform(-0.5, 2.5, size=(4, 8, 8, 16)).astype(np.float32)
    x.reshape(-1)[:4] = 1.7, 0.0, 1.7, 0.0
    beta = np.full(x.shape, 1.7, np.float32)
    cases = [(lambda a: fq.fake_quant_weight(a, bits), (w,)),
             (lambda a: fq.fake_quant_weight(a, bits, per_channel=True),
              (w.reshape(-1, 256),)),
             (lambda a: fq.fake_quant_weight_segmented(
                 a, ((0, 128, 8), (128, 256, bits))), (w,)),
             (lambda a, b: fq.fake_quant_act(a, b, bits, learned=True),
              (x, beta))]
    for fn, arrays in cases:
        outs = []
        for d in ("cpu", dev):
            ts = [torch.from_numpy(a).to(d).requires_grad_(True)
                  for a in arrays]
            y = fn(*ts)
            y.backward(torch.ones_like(y) * 0.5)
            outs.append([y.detach().cpu()] + [t.grad.cpu() for t in ts])
        for a, b in zip(*outs):
            assert torch.equal(a, b)


def _artifacts_equal(a, b) -> bool:
    """Two artifacts equal field for field, tensors byte for byte."""
    import dataclasses
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b))
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return all(_artifacts_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_artifacts_equal, a, b))
    return a == b


def test_qat_on_the_card_deploys_as_on_the_cpu(dev):
    """qat-cnn-smoke trained on the card: `fold_check` holds, and the
    artifact packed on the CPU and its integer logits equal the card's."""
    from repro_torch.convert import to_device
    from repro_torch.qat.data import make_dataset
    from repro_torch.qat.evaluate import deploy, fold_check
    from repro_torch.qat.train import QATConfig, train_qat
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import forward_int, quantize_input

    cfg = get_vision_config("qat-cnn", smoke=True)
    res = train_qat(cfg, make_dataset(), QATConfig(steps=10, batch=16,
                                                   w_bits=4, warmup=2),
                    device=dev)
    fold_check(res)
    q_card, q_cpu = deploy(res, device=dev), deploy(res, device="cpu")
    x, _ = next(make_dataset(split="test").batches(16, 1))
    assert _artifacts_equal(to_device(q_card, "cpu"), q_cpu)
    assert torch.equal(
        forward_int(q_card, quantize_input(q_card, x)).cpu(),
        forward_int(q_cpu, quantize_input(q_cpu, x)))


def test_qat_on_the_card_is_reproducible_from_its_seed(dev):
    """Full-width qat-cnn trained twice on the card at W2 from one seed:
    the trained weights and ranges equal bit for bit (cuDNN's
    nondeterministic weight-gradient sums gave another model each run)."""
    from repro_torch.qat.data import SyntheticDigits
    from repro_torch.qat.train import QATConfig, train_qat
    from repro_torch.nn.module import leaf_paths
    from repro_torch.vision.configs import get_vision_config

    cfg = get_vision_config("qat-cnn")
    data = SyntheticDigits(split="train", seed=0, noise=0.45, jitter=3)
    qc = QATConfig(steps=60, batch=64, lr=1e-2, w_bits=2, warmup=5)
    a, b = (train_qat(cfg, data, qc, device=dev) for _ in range(2))
    for (path, x), (_, y) in zip(leaf_paths(a.params), leaf_paths(b.params)):
        assert torch.equal(x, y), path
    assert {k: float(v) for k, v in a.absmax.items()} == {
        k: float(v) for k, v in b.absmax.items()}


def test_lm_train_step_on_the_card_matches_cpu(dev):
    """olmo-smoke at float32 from one CPU-drawn state: the loss within
    1e-5 and the gradients within 1e-4 x each leaf's largest |g|."""
    import dataclasses
    from repro_torch.convert import to_device
    from repro_torch.models.api import build, get_smoke_config
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(get_smoke_config("olmo-1b"),
                              compute_dtype="float32")
    model = build(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    l_cpu, g_cpu = loss_and_grads(model, params, batch)
    l_gpu, g_gpu = loss_and_grads(model, to_device(params, dev),
                                  to_device(batch, dev))
    assert abs(float(l_gpu) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for a, b in zip(g_cpu, g_gpu):
        assert float((b.cpu() - a).abs().max()) <= 1e-4 * float(
            a.abs().max()) + 1e-30


# card against the CPU, by compute dtype: float32 as the olmo test above;
# bf16 rounds each product to 8 mantissa bits (2^-8 = 3.9e-3) on either
# side, in different orders, so a few such roundings per layer
CONV_TRAIN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_lm_train_step_with_a_conv_is_reproducible_on_the_card(
        dev, arch, compute):
    """Mamba-2 and Griffin differentiate a depthwise `F.conv1d`
    (`nn/ssm.py::_causal_conv_dw`): two `loss_and_grads` calls from one
    state give the same gradients bit for bit, and each matches the CPU
    (loss and each leaf's gradient relative to its largest |g|,
    CONV_TRAIN_TOL)."""
    import dataclasses
    from repro_torch.convert import to_device
    from repro_torch.models.api import build, get_smoke_config
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=compute)
    model = build(cfg)
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    l_cpu, g_cpu = loss_and_grads(model, params, batch)
    on_card = to_device(params, dev), to_device(batch, dev)
    (l1, g1), (l2, g2) = (loss_and_grads(model, *on_card) for _ in range(2))
    assert float(l1) == float(l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    loss_tol, grad_tol = CONV_TRAIN_TOL[compute]
    assert abs(float(l1) - float(l_cpu)) <= loss_tol * abs(float(l_cpu))
    for a, b in zip(g_cpu, g1):
        assert float((b.cpu() - a).abs().max()) <= grad_tol * float(
            a.abs().max()) + 1e-30


def test_train_cli_on_the_card_resumes(dev, tmp_path):
    from repro_torch.launch import train as cli
    args = ["--arch", "qwen2.5-3b", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every",
            "2"]
    import shutil
    cli.main(args)
    shutil.rmtree(tmp_path / "step_00000004")
    second = cli.main(args)
    assert second["trainer"].restored_step == 2
    assert [r["step"] for r in second["log"]] == [3, 4]


# ------------------------------------------- LM tensor parallelism (tp) ---

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("pipeline", ["off", "double_buffer"])
def test_row_parallel_dense_on_the_card_equals_meshless(dev, m, pipeline):
    """qwen2.5-3b's mlp wo (11008 -> 2048) at W4A8, bf16, its K split at
    CHUNK boundaries over m positions of the card: the raw int32
    partials summed and dequantized once give the meshless launch's bits
    and the CPU's."""
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.nn import layers
    from repro_torch.parallel import tp
    gen = torch.Generator().manual_seed(m)
    w = torch.randn(11008, 2048, generator=gen) * 0.02
    wp, ws = layers.pack_dense_weights(w, 4)
    p = {"w_packed": wp.to(dev), "w_scale": ws.to(dev)}
    x = torch.randn(4, 11008, generator=gen).to(torch.bfloat16)
    q = layers.QuantConfig(mode="int", w_bits=4, a_bits=8, pipeline=pipeline)
    want = layers.dense_apply(p, x.to(dev), qcfg=q)
    cpu = layers.dense_apply({"w_packed": wp, "w_scale": ws}, x, qcfg=q)
    grp = tp.TPGroup(make_cluster_mesh(1, m, device=dev), 0)
    runs = tp.even_runs(11008, m, packing.CHUNK)
    for _ in range(2):
        got = layers.dense_row(p, tp.split(x.to(dev), runs, -1), qcfg=q,
                               runs=runs, group=grp, k_full=11008)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(want.cpu(), cpu)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_lm_engines_on_a_tp_card_mesh_match_meshless(dev, shape):
    """Each smoke family at W4A8 served on a (data, model) mesh of the
    card, twice: tokens equal to the meshless engine's."""
    import dataclasses

    from repro_torch.launch.convert import convert_params
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models import api as mapi
    from repro_torch.nn.layers import QuantConfig
    from repro_torch.serve.engine import Engine, Request

    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, 128, size=int(n)).astype(np.int32)
               for n in (3, 6, 2, 5)]
    for arch in ("qwen2.5-3b", "kimi-k2-1t-a32b", "seamless-m4t-large-v2",
                 "recurrentgemma-9b", "mamba2-370m"):
        base = mapi.get_smoke_config(arch)
        model = mapi.build(dataclasses.replace(
            base, quant=QuantConfig(mode="int", w_bits=4, a_bits=8)))
        params = convert_params(model.init(0, device=dev),
                                mapi.build(base).init(1, device=dev), 4)

        def run(mesh):
            eng = Engine(model, params, 4, 32, device=dev, mesh=mesh)
            return [r.out.tolist() for r in eng.generate(
                [Request(prompt=p, max_new_tokens=6) for p in prompts])]

        want = run(None)
        mesh = make_cluster_mesh(*shape, device=dev)
        assert run(mesh) == want and run(mesh) == want, arch


def test_lm_train_step_on_a_tp_card_mesh_matches_meshless(dev):
    """olmo-smoke at float32 on (1, 2) and (2, 2) of the card: the loss
    within 1e-5 and the gradients within 1e-4 x each leaf's largest |g|
    of the meshless step's."""
    import dataclasses
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models.api import build, get_smoke_config
    from repro_torch.train.step import loss_and_grads

    cfg = dataclasses.replace(get_smoke_config("olmo-1b"),
                              compute_dtype="float32")
    model = build(cfg)
    params = model.init(0, device=dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)).to(dev) for k in ("tokens", "labels")}
    l0, g0 = loss_and_grads(model, params, batch)
    for shape in ((1, 2), (2, 2)):
        l1, g1 = loss_and_grads(model, params, batch,
                                make_cluster_mesh(*shape, device=dev))
        assert abs(float(l1) - float(l0)) <= 1e-5 * abs(float(l0))
        for a, b in zip(g0, g1):
            assert float((b - a).abs().max()) <= 1e-4 * float(
                a.abs().max()) + 1e-30
