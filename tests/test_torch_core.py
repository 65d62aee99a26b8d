"""The port's `core` (`quantize_linear`, `lin`, `batchnorm_int`,
`calibrate_activation`, `RunningCalibrator`, the package's re-exports)
against the reference's `repro.core`, on the CPU, from numpy-seeded
inputs.

Exact throughout: the artifact's bytes and fields, the int32 results of
eqs. 2-3 (their int32 wrap included), and the calibrated beta as the
same float (both take numpy's percentile of the same float32 samples).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as r_core
import repro_torch.core as p_core
from repro_torch.core import calibration as p_cal

from torch_bridge import assert_artifacts_equal, assert_same

r_q = importlib.import_module("repro.core.quantize")
p_q = importlib.import_module("repro_torch.core.quantize")
r_cal = importlib.import_module("repro.core.calibration")

BITS = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2)]


def _spec(ref):
    return p_q.QuantSpec(**dataclasses.asdict(ref))


@pytest.mark.parametrize("k,n", [(200, 140), (128, 1), (37, 300)])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_quantize_linear_same_artifact(a_bits, w_bits, k, n):
    """quantize -> pad -> pack -> fold: the same `QuantizedLinearParams`
    (w_packed, kappa, lam, m, d, k_logical and every width) from the same
    float inputs, ragged K and N included."""
    rng = np.random.default_rng(a_bits * 100 + w_bits * 10 + k % 7)
    w = rng.normal(size=(k, n)).astype(np.float32)
    bn_s = (rng.normal(size=(n,)) * 0.2 + 0.6).astype(np.float32)
    bn_b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    spec_w = r_q.QuantSpec.weight(w_bits, float(np.abs(w).max()))
    spec_x = r_q.QuantSpec.activation(a_bits, 1.5)
    spec_y = r_q.QuantSpec.activation(a_bits, 0.3)
    ref = r_q.quantize_linear(jnp.asarray(w), spec_w, bn_s, bn_b, spec_x,
                              spec_y)
    port = p_core.quantize_linear(torch.from_numpy(w), _spec(spec_w),
                                  torch.from_numpy(bn_s),
                                  torch.from_numpy(bn_b), _spec(spec_x),
                                  _spec(spec_y))
    assert type(port) is p_q.QuantizedLinearParams
    assert_artifacts_equal(port, ref, "quantize_linear")
    assert port.w_packed.shape[0] == (k + (-k) % 128) * w_bits // 8
    assert port.k_logical == k


@pytest.mark.parametrize("shape", [(5, 33), (2, 3, 130)])
def test_lin_equal(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-128, 128, size=shape).astype(np.int8)
    w = rng.integers(-128, 128, size=(shape[-1], 17)).astype(np.int8)
    got = p_core.lin(torch.from_numpy(w), torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert_same(got, r_core.lin(jnp.asarray(w), jnp.asarray(x)))


def test_lin_wraps_int32():
    # 140,000 products of -128 x -128 sum to 2,293,760,000 > 2^31 - 1:
    # the int32 accumulator wraps, in both packages
    k = 140_000
    x = np.full((2, k), -128, np.int8)
    w = np.full((k, 3), -128, np.int8)
    w[:, 2] = 1
    got = p_core.lin(torch.from_numpy(w), torch.from_numpy(x))
    want = r_core.lin(jnp.asarray(w), jnp.asarray(x))
    assert_same(got, want)
    assert int(got[0, 0]) == 128 * 128 * k - 2 ** 32


@pytest.mark.parametrize("wraps", [False, True])
def test_batchnorm_int_equal(wraps):
    rng = np.random.default_rng(3 + wraps)
    hi = 2 ** 30 if wraps else 2 ** 20
    phi = rng.integers(-hi, hi, size=(6, 40)).astype(np.int32)
    kappa = rng.integers(-127, 128, size=40).astype(np.int32)
    lam = rng.integers(-hi, hi, size=40).astype(np.int32)
    got = p_core.batchnorm_int(torch.from_numpy(phi), torch.from_numpy(kappa),
                               torch.from_numpy(lam))
    want = r_core.batchnorm_int(jnp.asarray(phi), jnp.asarray(kappa),
                                jnp.asarray(lam))
    assert got.dtype == torch.int32
    assert_same(got, want)
    exact = phi.astype(np.int64) * kappa + lam
    wrapped = (exact != got.numpy().astype(np.int64)).any()
    assert wrapped == wraps


def _samples(seed, shape=(64, 300)):
    rng = np.random.default_rng(seed)
    return (rng.standard_t(3, size=shape) * 0.7).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
@pytest.mark.parametrize("percentile", [99.9, 100.0])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_calibrate_activation_same_spec(bits, percentile, as_tensor):
    x = _samples(bits)
    spec = p_cal.calibrate_activation(torch.from_numpy(x) if as_tensor
                                      else x, bits, percentile)
    ref = r_cal.calibrate_activation(jnp.asarray(x), bits, percentile)
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
    assert type(spec.beta) is float and spec.eps == ref.eps
    assert not spec.signed and spec.alpha == 0.0


def test_calibrate_activation_of_nonpositive_samples_floors_beta():
    x = -np.abs(_samples(5))
    spec = p_cal.calibrate_activation(x, 8)
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        r_cal.calibrate_activation(x, 8))
    assert spec.beta == 1e-8


@pytest.mark.parametrize("momentum,percentile", [(0.9, 99.9), (0.5, 100.0)])
def test_running_calibrator_same_spec(momentum, percentile):
    port = p_core.RunningCalibrator(4, momentum, percentile)
    ref = r_core.RunningCalibrator(4, momentum, percentile)
    for i in range(5):
        x = _samples(10 + i, shape=(8, 50 + 10 * i)) * (1 + i)
        port.observe(torch.from_numpy(x) if i % 2 else x)
        ref.observe(jnp.asarray(x))
        assert dataclasses.asdict(port.spec()) == dataclasses.asdict(
            ref.spec()), i
    empty = np.zeros((0,), np.float32)
    port.observe(empty)
    ref.observe(empty)
    assert dataclasses.asdict(port.spec()) == dataclasses.asdict(ref.spec())


def test_running_calibrator_raises_with_no_observation():
    for cls in (p_core.RunningCalibrator, r_core.RunningCalibrator):
        with pytest.raises(ValueError, match="no observations"):
            cls(8).spec()


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_core_exports_the_reference_names():
    assert _public(p_core) == _public(r_core)
    # as in the reference, the function shadows its module's name
    assert p_core.quantize is p_q.quantize and callable(p_core.quantize)
    for name in ("quantize_linear", "lin", "batchnorm_int",
                 "calibrate_activation", "RunningCalibrator",
                 "calibrate_weight", "CHUNK", "M_BITS", "D_MIN", "D_MAX"):
        assert hasattr(p_core, name), name
    assert (p_core.CHUNK, p_core.M_BITS, p_core.D_MIN, p_core.D_MAX) == (
        r_core.CHUNK, r_core.M_BITS, r_core.D_MIN, r_core.D_MAX)


def test_one_layer_pipeline_runs_in_the_port_alone():
    """Eqs. 1-4 for one layer without the reference: quantize_linear's
    artifact, `lin` on the unpacked weights, `batchnorm_int` and
    `qnt_act` give the codes the fused `qdot` 'int' epilogue gives, and
    those equal the reference's chain on the same floats."""
    from repro_torch.kernels import api as p_api
    rng = np.random.default_rng(11)
    k, n, m = 150, 70, 9
    w = rng.normal(size=(k, n)).astype(np.float32)
    bn_s = (rng.normal(size=(n,)) * 0.2 + 0.6).astype(np.float32)
    bn_b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    x = np.abs(rng.normal(size=(m, k))).astype(np.float32)
    spec_w = p_q.QuantSpec.weight(4, float(np.abs(w).max()))
    spec_x = p_cal.calibrate_activation(x, 8, 100.0)
    spec_y = p_q.QuantSpec.activation(8, 2.0)
    art = p_core.quantize_linear(torch.from_numpy(w), spec_w, bn_s, bn_b,
                                 spec_x, spec_y)
    x_hat = p_core.quantize(torch.from_numpy(x), spec_x)
    w_hat = p_core.unpack(art.w_packed, 4, True, axis=0)[:k]
    phi = p_core.batchnorm_int(p_core.lin(w_hat, x_hat), art.kappa, art.lam)
    y = p_core.qnt_act(phi, art.m, art.d, art.out_bits)
    fused = p_api.qdot(art, p_core.pad_to_chunk(x_hat), epilogue="int")
    assert torch.equal(y, fused)
    r_art = r_core.quantize_linear(
        jnp.asarray(w), r_q.QuantSpec(**dataclasses.asdict(spec_w)), bn_s,
        bn_b, r_q.QuantSpec(**dataclasses.asdict(spec_x)),
        r_q.QuantSpec(**dataclasses.asdict(spec_y)))
    r_x = r_core.quantize(jnp.asarray(x), r_q.QuantSpec(
        **dataclasses.asdict(spec_x)))
    r_w = r_core.quantize(jnp.asarray(w), r_q.QuantSpec(
        **dataclasses.asdict(spec_w)))
    r_y = r_core.qnt_act(r_core.batchnorm_int(r_core.lin(r_w, r_x),
                                              r_art.kappa, r_art.lam),
                         r_art.m, r_art.d, r_art.out_bits)
    assert_same(y, r_y)
