"""The port's storage and quantization formats against the JAX reference.

Every comparison is exact: packed bytes, unpacked values, requant floors,
BN-fold integers and quantized codes must be identical.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import calibration as r_cal
from repro.core import packing as r_pack
from repro_torch.core import calibration as p_cal
from repro_torch.core import packing as p_pack
from repro_torch.kernels.qmatmul.ref import unpack_np

from torch_bridge import assert_same

# repro.core re-exports a function named `quantize` over the module name
r_q = importlib.import_module("repro.core.quantize")
p_q = importlib.import_module("repro_torch.core.quantize")


def _values(rng, bits, signed, shape):
    lo, hi = r_pack.int_range(bits, signed)
    return rng.integers(lo, hi + 1, size=shape).astype(np.int8)


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_pack_unpack_byte_identical(bits, signed, axis, rng):
    shape = (256, 6) if axis == 0 else (3, 5, 384)
    v = _values(rng, bits, signed, shape)
    ref = r_pack.pack(jnp.asarray(v), bits, axis=axis)
    port = p_pack.pack(torch.from_numpy(v), bits, axis=axis)
    assert_same(port, ref, "pack")
    back = p_pack.unpack(port, bits, signed, axis=axis)
    assert_same(back, r_pack.unpack(ref, bits, signed, axis=axis), "unpack")
    assert_same(back, v, "round trip")
    np.testing.assert_array_equal(
        unpack_np(np.asarray(ref), bits, signed, axis=axis), v)


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_pack_of_a_strided_view_is_contiguous_and_identical(bits, axis, rng):
    # the kernels take contiguous containers; activations can reach the
    # packer as a transposed view (an einsum's output layout)
    shape = (256, 6) if axis == 0 else (6, 256)
    v = _values(rng, bits, True, shape[::-1]).T
    port = p_pack.pack(torch.from_numpy(v), bits, axis=axis)
    assert port.is_contiguous()
    assert_same(port, r_pack.pack(jnp.asarray(v), bits, axis=axis), "pack")


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_planes_perm_and_padding_match(bits, rng):
    v = _values(rng, bits, True, (2 * p_pack.CHUNK // p_pack.pack_factor(
        bits), 3)).astype(np.int8)
    for pp, rp in zip(p_pack.unpack_planes(torch.from_numpy(v), bits, True),
                      r_pack.unpack_planes(jnp.asarray(v), bits, True)):
        assert_same(pp, rp, "plane")
    np.testing.assert_array_equal(p_pack.planar_perm(256, bits),
                                  r_pack.planar_perm(256, bits))
    x = _values(rng, bits, True, (4, 70))
    assert_same(p_pack.pad_to_chunk(torch.from_numpy(x), axis=-1),
                r_pack.pad_to_chunk(jnp.asarray(x), axis=-1), "pad")
    assert p_pack.padded_size(70) == r_pack.padded_size(70) == 128


def test_check_range_refuses_off_grid_values():
    with pytest.raises(ValueError, match="silently truncate"):
        p_pack.pack(torch.tensor([[8] * 128], dtype=torch.int8), 4,
                    assert_range=True)
    with pytest.raises(ValueError, match="unsupported bitwidth"):
        p_pack.pack_factor(3)


def _boundary_phis():
    edges = [0, 1, -1, 0xFFFF, 0x10000, -0x10000, -0x10001, 2**24 + 7,
             -(2**24) - 7, 2**31 - 1, -(2**31)]
    rng = np.random.default_rng(5)
    return np.asarray(edges + list(rng.integers(-(2**31), 2**31, 200)),
                      np.int64)


@pytest.mark.parametrize("d", list(range(16, 32)))
def test_requantize_shift_matches_int64_oracle(d):
    phi = _boundary_phis()
    for m in (0, 1, 2**14, 2**15 - 1, 12345):
        port = p_q.requantize_shift(torch.from_numpy(phi).to(torch.int32),
                                    m, d)
        oracle = r_q.requantize_shift_i64(phi, m, d)
        np.testing.assert_array_equal(port.numpy().astype(np.int64), oracle)
        np.testing.assert_array_equal(p_q.requantize_shift_i64(phi, m, d),
                                      oracle)
        ref = r_q.requantize_shift(jnp.asarray(phi.astype(np.int32)),
                                   jnp.int32(m), d)
        assert_same(port, ref, f"m={m}")
    for out_bits in (8, 4, 2):
        assert_same(p_q.qnt_act(torch.from_numpy(phi).to(torch.int32),
                                12345, d, out_bits),
                    r_q.qnt_act(jnp.asarray(phi.astype(np.int32)),
                                jnp.int32(12345), d, out_bits), "qnt_act")


@pytest.mark.parametrize("out_bits", [8, 4, 2])
def test_fold_bn_requant_and_pick_md_identical(out_bits, rng):
    for _ in range(4):
        scale = (rng.normal(size=(37,)) * 0.3 + 0.5).astype(np.float32)
        bias = (rng.normal(size=(37,)) * 0.2).astype(np.float32)
        eps_w, eps_x, eps_y = (float(v) for v in
                               rng.uniform(1e-3, 5e-2, size=3))
        ref = r_q.fold_bn_requant(eps_w, eps_x, eps_y, scale, bias,
                                  out_bits)
        port = p_q.fold_bn_requant(eps_w, eps_x, eps_y,
                                   torch.from_numpy(scale),
                                   torch.from_numpy(bias), out_bits)
        for p, r in zip(port[:3], ref[:3]):
            assert_same(p, r, "kappa/lam/m")
        assert port[3] == ref[3]
    for ratio in (1e-6, 3.3e-4, 0.01, 0.49):
        assert p_q.pick_requant_md(ratio) == r_q.pick_requant_md(ratio)
    for ratio in (3.3e-4, 0.49, 0.9, 1.7):
        assert (p_q.pick_requant_md(ratio, d_min=0)
                == r_q.pick_requant_md(ratio, d_min=0))
    with pytest.raises(ValueError, match="too large"):
        p_q.pick_requant_md(0.9)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_identical_codes_including_half_steps(bits, signed, rng):
    spec_args = (bits, 0.8137) if not signed else (bits, 1.3711)
    rs = (r_q.QuantSpec.activation if not signed
          else r_q.QuantSpec.weight)(*spec_args)
    ps = (p_q.QuantSpec.activation if not signed
          else p_q.QuantSpec.weight)(*spec_args)
    assert (ps.eps, ps.int_min, ps.int_max) == (rs.eps, rs.int_min,
                                                rs.int_max)
    eps32 = np.float32(rs.eps)
    # values a float32 division puts on (or next to) the .5 boundaries
    k = np.arange(-rs.int_max - 2, rs.int_max + 2, dtype=np.float32)
    halves = ((k + np.float32(0.5)) * eps32).astype(np.float32)
    near = np.concatenate([halves, np.nextafter(halves, np.float32(9)),
                           np.nextafter(halves, np.float32(-9))])
    t = np.concatenate([near, rng.normal(size=500).astype(np.float32)])
    ref = r_q.quantize(jnp.asarray(t), rs)
    port = p_q.quantize(torch.from_numpy(t), ps)
    assert_same(port, ref, "codes")
    assert_same(p_q.dequantize(port, ps), r_q.dequantize(ref, rs), "deq")


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_calibrate_weight_same_spec(bits, rng):
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    r, p = r_cal.calibrate_weight(jnp.asarray(w), bits), \
        p_cal.calibrate_weight(torch.from_numpy(w), bits)
    assert (p.bits, p.signed, p.alpha, p.beta) == (r.bits, r.signed,
                                                   r.alpha, r.beta)
