"""The port's depthwise layer (`QDepthwiseConv2D`, both lowerings) against
the reference, on the CPU.

Artifacts: `quantize_depthwise` must build the block-diagonal GEMM, the
one (kappa, lam, m, d) fold and every channel's conv layouts byte for
byte as the reference does. Outputs are integers and must be identical:
the two lowerings against each other, against the reference's layer
under `xla` and `eager_ref` (both lowerings), against an int64 numpy
depthwise oracle, and at one size against the reference's per-group
lowering on the Pallas kernel under the interpreter with
``REPRO_QPIPELINE=double_buffer`` (its pipeline 'off' fails under jax
0.9). The one toleranced check is `depthwise_fp`, a float conv (XLA
against torch's CPU conv, summed in other orders): rtol and atol 1e-5.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import packing as r_pack
from repro.core.calibration import calibrate_weight
from repro.vision import layers as r_vl
from repro_torch.vision import layers as p_vl

from torch_bridge import assert_artifacts_equal, assert_same

r_q = importlib.import_module("repro.core.quantize")
p_q = importlib.import_module("repro_torch.core.quantize")
BITS = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2)]


def _layer(c, a_bits, w_bits, stride, seed=0):
    """The same depthwise node quantized by both packages."""
    rng = np.random.default_rng(seed + 100 * c + 10 * a_bits + w_bits)
    p = {"w": (rng.normal(size=(3, 3, c)) * 0.4).astype(np.float32),
         "bn_scale": (rng.normal(size=(c,)) * 0.05 + 0.4).astype(
             np.float32),
         "bn_bias": (rng.normal(size=(c,)) * 0.02).astype(np.float32)}
    ref = r_vl.quantize_depthwise(
        {k: jnp.asarray(v) for k, v in p.items()},
        r_q.QuantSpec.activation(a_bits, 2.0),
        r_q.QuantSpec.activation(a_bits, 1.5), w_bits, stride=stride,
        padding=1)
    port = p_vl.quantize_depthwise(
        {k: torch.from_numpy(v) for k, v in p.items()},
        p_q.QuantSpec.activation(a_bits, 2.0),
        p_q.QuantSpec.activation(a_bits, 1.5), w_bits, stride=stride,
        padding=1)
    hi = r_pack.int_range(a_bits, False)[1]
    x = rng.integers(0, hi + 1, size=(2, 6, 6, c)).astype(np.int8)
    return ref, port, x, p["w"]


def _dw_oracle(x, w_hat, kappa, lam, m, d, out_bits, stride, padding):
    """Independent numpy depthwise conv + eq. 3/4 epilogue (int64)."""
    n, h, wd, c = x.shape
    fh, fw, _ = w_hat.shape
    xp = np.zeros((n, h + 2 * padding, wd + 2 * padding, c), np.int64)
    xp[:, padding:padding + h, padding:padding + wd] = x
    oh = (h + 2 * padding - fh) // stride + 1
    ow = (wd + 2 * padding - fw) // stride + 1
    phi = np.zeros((n, oh, ow, c), np.int64)
    for dy in range(fh):
        for dx in range(fw):
            sl = xp[:, dy:dy + stride * oh:stride,
                    dx:dx + stride * ow:stride]
            phi += sl * w_hat[dy, dx].astype(np.int64)
    phi_p = phi * kappa.astype(np.int64) + lam.astype(np.int64)
    y = r_q.requantize_shift_i64(phi_p, m.astype(np.int64), d)
    hi = r_pack.int_range(out_bits, False)[1]
    return np.clip(y, 0, hi).astype(np.int8)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [3, 16, 130])
@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_quantize_depthwise_artifacts_byte_identical(w_bits, c, stride):
    ref, port, _, _ = _layer(c, 8, w_bits, stride)
    assert_artifacts_equal(port, ref, "depthwise")
    assert len(port.per_group) == c
    # one fold: every channel's vectors are the layer's, sliced, each in
    # storage of its own (the conv kernel copies them 16 bytes at a time
    # from where they start)
    for ci, pg in enumerate(port.per_group):
        assert pg.gemm.d == port.gemm.d
        for f in ("kappa", "lam", "m"):
            v = getattr(pg.gemm, f)
            assert_same(v, getattr(port.gemm, f)[ci:ci + 1], f)
            assert v.storage_offset() == 0, f
        assert pg.cin_pad == 128 and pg.w_packed_fused.shape[-1] == 1


@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_lowerings_identical_to_reference_and_oracle(a_bits, w_bits):
    ref, port, x, w = _layer(8, a_bits, w_bits, stride=2)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    got = {low: port.apply(xt, lowering=low)
           for low in ("qdot", "per_group", "auto")}
    wj = jnp.asarray(w)
    w_hat = np.asarray(r_q.quantize(wj, calibrate_weight(wj, w_bits)))
    g = ref.gemm
    oracle = _dw_oracle(x, w_hat, np.asarray(g.kappa), np.asarray(g.lam),
                        np.asarray(g.m), g.d, g.out_bits, 2, 1)
    for low, out in got.items():
        assert out.dtype == torch.int8 and out.shape == (2, 3, 3, 8)
        assert_same(out, oracle, f"{low} vs oracle")
        for backend in ("xla", "eager_ref"):
            for rlow in ("qdot", "per_group"):
                assert_same(out, ref.apply(xj, backend=backend,
                                           lowering=rlow),
                            f"{low} vs {backend} {rlow}")


@pytest.mark.parametrize("stride", [1, 2])
def test_per_group_matches_pallas_interpret_double_buffer(stride,
                                                          monkeypatch):
    monkeypatch.setenv("REPRO_QPIPELINE", "double_buffer")
    ref, port, x, _ = _layer(3, 4, 2, stride)
    want = ref.apply(jnp.asarray(x), backend="pallas_interpret",
                     lowering="per_group")
    xt = torch.from_numpy(x)
    for low in ("qdot", "per_group"):
        assert_same(port.apply(xt, lowering=low), want,
                    f"{low} vs pallas_interpret per_group")


def test_auto_is_qdot_on_the_cpu_and_unknown_lowering_raises():
    _, port, x, _ = _layer(4, 8, 8, stride=1)
    assert p_vl.AUTO_LOWERING == "qdot"
    xt = torch.from_numpy(x)
    assert torch.equal(port.apply(xt), port.apply(xt, lowering="qdot"))
    with pytest.raises(ValueError, match="unknown depthwise lowering"):
        port.apply(xt, lowering="nope")
    with pytest.raises(ValueError, match="pipeline"):
        port.apply(xt, pipeline="triple")


def test_depthwise_fp_matches_reference_and_taps(rng):
    x = rng.normal(size=(2, 7, 7, 5)).astype(np.float32)
    p = {"w": rng.normal(size=(3, 3, 5)).astype(np.float32),
         "bn_scale": rng.normal(size=(5,)).astype(np.float32),
         "bn_bias": rng.normal(size=(5,)).astype(np.float32)}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    seen = []
    with p_vl.conv_tap(lambda node, xin: seen.append(node["w"].shape)):
        for stride in (1, 2):
            got = p_vl.depthwise_fp(pt, torch.from_numpy(x), stride=stride,
                                    padding=1)
            want = r_vl.depthwise_fp({k: jnp.asarray(v)
                                      for k, v in p.items()},
                                     jnp.asarray(x), stride=stride,
                                     padding=1)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    assert seen == [(3, 3, 5)] * 2
