"""The port's `qconv` (the `torch` backend, on CPU) against the reference.

Artifacts: `quantize_conv` must build byte-identical weight layouts and
epilogue vectors. Outputs: held against `repro.kernels.api.qconv` with
`xla`, `eager_ref` (the 'int' epilogue only), the Pallas kernel under the
interpreter with ``pipeline='double_buffer'``, and the numpy direct
convolution `qconv2d_ref`. The reference's ``pipeline='off'`` interpreter
path fails under jax 0.9 (`pl.load` is gone) and is not used.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import api as r_api
from repro.kernels.qconv import ops as r_ops
from repro.kernels.qconv.ref import qconv2d_ref
from repro_torch.core import packing as p_pack
from repro_torch.kernels import api as p_api
from repro_torch.kernels.qconv import ops as p_ops
from repro_torch.kernels.qconv.kernel import qconv2d_fused, qconv_packed_cuda
from repro_torch.kernels.qconv.ref import qconv2d_ref as p_qconv2d_ref

from torch_bridge import assert_artifacts_equal, assert_same

r_q = importlib.import_module("repro.core.quantize")
p_q = importlib.import_module("repro_torch.core.quantize")

# (n, h, w, cin, cout, f, stride, padding): Cin off the CHUNK grid, Cin
# past one CHUNK, 1x1 stride 2, padding 0, ragged Cout
GEOMS = {
    "3x3s1p1_cin5": (2, 9, 7, 5, 20, 3, 1, 1),
    "3x3s2p1_cin130": (2, 8, 8, 130, 70, 3, 2, 1),
    "1x1s2p0": (1, 9, 9, 16, 8, 1, 2, 0),
    "3x3s1p0_cin3": (2, 10, 6, 3, 16, 3, 1, 0),
}
BITS = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2)]


def _layer(geom, a_bits, w_bits, seed=0):
    """The same conv quantized by both packages from the same numbers."""
    n, h, w_, cin, cout, f, s, p = GEOMS[geom]
    rng = np.random.default_rng(seed + a_bits * 10 + w_bits)
    w = rng.normal(size=(f, f, cin, cout)).astype(np.float32)
    bn_s = (rng.normal(size=(cout,)) * 0.2 + 0.6).astype(np.float32)
    bn_b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    absmax = float(np.abs(w).max())
    specs = [(mod.QuantSpec.weight(w_bits, absmax),
              mod.QuantSpec.activation(a_bits, 1.0),
              mod.QuantSpec.activation(a_bits, 0.5 * f * f))
             for mod in (r_q, p_q)]
    ref = r_ops.quantize_conv(jnp.asarray(w), *specs[0][:1], bn_s, bn_b,
                              *specs[0][1:], stride=s, padding=p)
    port = p_ops.quantize_conv(torch.from_numpy(w), *specs[1][:1],
                               torch.from_numpy(bn_s),
                               torch.from_numpy(bn_b), *specs[1][1:],
                               stride=s, padding=p)
    hi = p_pack.int_range(a_bits, False)[1]
    x = rng.integers(0, hi + 1, size=(n, h, w_, cin)).astype(np.int8)
    return ref, port, x


def _ref_oracle(ref, x):
    from repro.kernels.qmatmul.ref import unpack_np
    g = ref.gemm
    w_flat = unpack_np(np.asarray(ref.w_packed_fused), g.w_bits, True, 0)
    w_hat = w_flat.reshape(ref.fh * ref.fw, ref.cin_pad, ref.cout)[
        :, :ref.cin].reshape(ref.fh, ref.fw, ref.cin, ref.cout)
    return w_hat, (np.asarray(g.kappa), np.asarray(g.lam), np.asarray(g.m),
                   g.d, g.out_bits)


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qconv_int_matches_xla_eager_and_oracle(geom, a_bits, w_bits):
    ref, port, x = _layer(geom, a_bits, w_bits)
    assert_artifacts_equal(port, ref, "conv")
    out = p_api.qconv(port, torch.from_numpy(x))
    xj = jnp.asarray(x)
    for backend in ("xla", "eager_ref"):
        assert_same(out, r_api.qconv(ref, xj, backend=backend), backend)
    w_hat, (kappa, lam, m, d, ob) = _ref_oracle(ref, x)
    oracle = qconv2d_ref(x, w_hat, kappa, lam, m, d, ob,
                         stride=ref.stride, padding=ref.padding)
    assert_same(out, oracle, "qconv2d_ref")
    np.testing.assert_array_equal(
        p_qconv2d_ref(x, w_hat, kappa, lam, m, d, ob, stride=ref.stride,
                      padding=ref.padding), oracle)


@pytest.mark.parametrize("epilogue", ["raw", "dequant"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qconv_raw_and_dequant_match_xla(a_bits, w_bits, epilogue):
    ref, port, x = _layer("3x3s2p1_cin130", a_bits, w_bits)
    out = p_api.qconv(port, torch.from_numpy(x), epilogue=epilogue,
                      scale=0.0071)
    assert_same(out, r_api.qconv(ref, jnp.asarray(x), epilogue=epilogue,
                                 scale=0.0071, backend="xla"), epilogue)


@pytest.mark.parametrize("geom", ["3x3s1p1_cin5", "3x3s2p1_cin130"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_qconv_matches_pallas_interpret_double_buffer(geom, a_bits, w_bits):
    ref, port, x = _layer(geom, a_bits, w_bits)
    out = p_api.qconv(port, torch.from_numpy(x), pipeline="double_buffer")
    # bho=2 leaves a ragged last row tile (Ho = 9 and 4 rows -> 5 and 2
    # tiles); bn=128 gives one Cout panel
    want = r_api.qconv(ref, jnp.asarray(x), backend="pallas_interpret",
                       pipeline="double_buffer", block=(2, 128))
    assert_same(out, want, "pallas_interpret double_buffer")


@pytest.mark.parametrize("epilogue", ["raw", "dequant"])
def test_qconv_pallas_interpret_other_epilogues(epilogue):
    ref, port, x = _layer("3x3s1p1_cin5", 4, 2)
    out = p_api.qconv(port, torch.from_numpy(x), epilogue=epilogue,
                      scale=0.031, pipeline="double_buffer")
    want = r_api.qconv(ref, jnp.asarray(x), epilogue=epilogue, scale=0.031,
                       backend="pallas_interpret",
                       pipeline="double_buffer", block=(4, 128))
    assert_same(out, want, epilogue)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_im2col_hwc_matches(geom, rng):
    n, h, w_, cin, _, f, s, p = GEOMS[geom]
    x = rng.integers(-100, 100, size=(n, h, w_, cin)).astype(np.int8)
    cols, ho, wo = p_ops.im2col_hwc(torch.from_numpy(x), f, f, s, p)
    rcols, rho, rwo = r_ops.im2col_hwc(jnp.asarray(x), f, f, s, p)
    assert (ho, wo) == (rho, rwo)
    assert_same(cols, rcols, "im2col")


def test_grouped_params_are_rejected():
    import dataclasses
    _, port, x = _layer("1x1s2p0", 8, 8)
    grouped = dataclasses.replace(port, groups=2)
    with pytest.raises(ValueError, match="grouped conv"):
        p_api.qconv(grouped, torch.from_numpy(x))


def test_conv_kernel_wrapper_refuses_cpu_tensors():
    _, port, x = _layer("3x3s1p1_cin5", 8, 4)
    g = port.gemm
    # the image as the kernel reads it: unpadded, Cin 5 copied to 8
    xs = torch.nn.functional.pad(torch.from_numpy(x), (0, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        qconv_packed_cuda(xs, port.w_packed_fused, g.kappa, g.lam, g.m,
                          fh=3, fw=3, stride=1, padding=1, cin=5,
                          cin_pad=port.cin_pad, cout=port.cout, a_bits=8,
                          a_signed=False, w_bits=4, d=g.d, out_bits=8)
    # the kernel takes K one CHUNK of one tap at a time: cin_pad must be a
    # CHUNK multiple, which the dispatching wrapper checks on any device
    with pytest.raises(ValueError, match="cin_pad=100"):
        qconv2d_fused(torch.from_numpy(x), port.w_packed_fused, g.kappa,
                      g.lam, g.m, fh=3, fw=3, stride=1, padding=1,
                      cin_pad=100, cout=port.cout, a_bits=8, a_signed=False,
                      w_bits=4, d=g.d, out_bits=8)


@pytest.mark.parametrize("observed", [False, True])
def test_resnet8_w4a8_forward_copies_only_the_stem(observed):
    """Of ResNet-8's nine convs at W4A8 only the stem's 3-channel image is
    copied before the kernel (to 4 channels, 4 KB an image, no border);
    ``qconv.staged`` / ``qconv.staged_bytes`` say so with observability
    on, and nothing is recorded with it off."""
    from repro_torch import obs as obs_pkg
    from repro_torch.obs import counters as obs_counters
    from repro_torch.obs import trace as obs
    from repro_torch.vision import models
    from repro_torch.vision.configs import get_vision_config

    cfg = get_vision_config("resnet8")
    fp = models.init_fp(cfg, 0, device="cpu")
    imgs = np.random.default_rng(3).uniform(0, 1, (2, *cfg.in_hw, 3))
    absmax = models.collect_absmax(cfg, fp, [imgs.astype(np.float32)])
    qnet = models.quantize_net(cfg, fp, absmax, default_w_bits=4,
                               device="cpu")
    x = models.quantize_input(qnet, imgs)
    was = obs.enabled()
    obs_pkg.reset()
    (obs.enable if observed else obs.disable)()
    try:
        models.forward_int(qnet, x)
        got = obs.counter_values()
        calls = sum(v["calls"] for k, v in obs_counters.snapshot().items()
                    if k.startswith("qconv|"))
    finally:
        obs_pkg.reset()
        (obs.enable if was else obs.disable)()
    if not observed:
        assert got == {} and calls == 0
        return
    assert calls == 9
    assert got["qconv.staged"] == 1
    assert got["qconv.staged_bytes"] == 2 * 32 * 32 * 4
