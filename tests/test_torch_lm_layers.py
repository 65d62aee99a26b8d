"""The port's LM layers (`repro_torch.nn.layers`) against the reference's,
on the CPU, from the same numpy inputs.

Exact: the dense weight quantizer and both packers (codes, scales,
packed bytes), `dense_apply` in int mode (bf16 bit patterns and float32
values, A{8,4,2} x W{8,4,2}, uniform and segmented) and `fake_quantize`.
Within a stated tolerance: the norms, the rope functions and
`dense_apply` in off and fake modes (float32 rounding order differs
between torch and XLA: 1e-5 relative).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.nn import layers as r_layers
from repro_torch.nn import layers as p_layers

from torch_bridge import assert_same

r_quant = importlib.import_module("repro.core.quantize")
p_quant = importlib.import_module("repro_torch.core.quantize")

K, N = 200, 320                    # ragged K (two chunks), a ragged N tail
SEGMENTS = ((0, 128, 8), (128, 256, 4), (256, 320, 2))
BITS = [(a, w) for a in (8, 4, 2) for w in (8, 4, 2)]
# float32 math in another rounding order (torch vs XLA): relative
RTOL = 1e-5


def _weights(seed=0, shape=(K, N)):
    return (np.random.default_rng(seed).normal(size=shape) * 0.1).astype(
        np.float32)


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_quantize_and_pack_dense_weights_identical(w_bits):
    w = _weights(w_bits, (3, K, N))          # a stacked (L, K, N) leaf
    r_hat, r_scale = r_layers.quantize_dense_weights(jnp.asarray(w), w_bits)
    p_hat, p_scale = p_layers.quantize_dense_weights(torch.from_numpy(w),
                                                     w_bits)
    assert_same(p_hat, r_hat, "codes")
    assert_same(p_scale, r_scale, "scales")
    r_pk, r_sc = r_layers.pack_dense_weights(jnp.asarray(w), w_bits,
                                             assert_range=True)
    p_pk, p_sc = p_layers.pack_dense_weights(torch.from_numpy(w), w_bits,
                                             assert_range=True)
    assert_same(p_pk, r_pk, "packed")
    assert_same(p_sc, r_sc, "packed scales")


@pytest.mark.parametrize("segments", [SEGMENTS, ((0, 128, 2), (128, 320, 8))])
def test_pack_dense_weights_segmented_identical(segments):
    w = _weights(1, (2, K, N))
    r_pk, r_sc = r_layers.pack_dense_weights_segmented(
        jnp.asarray(w), segments, assert_range=True)
    p_pk, p_sc = p_layers.pack_dense_weights_segmented(
        torch.from_numpy(w), segments, assert_range=True)
    assert_same(p_pk, r_pk, "segmented buffer")
    assert_same(p_sc, r_sc, "segmented scales")
    with pytest.raises(ValueError, match="segment map covers"):
        p_layers.pack_dense_weights_segmented(torch.from_numpy(w[..., :-1]),
                                              segments)


def _int_params(w_bits, segments, seed):
    w = _weights(seed)
    if segments is None:
        pk, sc = r_layers.pack_dense_weights(jnp.asarray(w), w_bits)
    else:
        pk, sc = r_layers.pack_dense_weights_segmented(jnp.asarray(w),
                                                       segments)
    b = np.random.default_rng(seed + 1).normal(size=(N,)).astype(np.float32)
    ref = {"w_packed": pk, "w_scale": sc, "b": jnp.asarray(b)}
    return ref, {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["uniform", "segmented"])
@pytest.mark.parametrize("a_bits,w_bits", BITS)
def test_dense_apply_int_bit_exact(a_bits, w_bits, segmented):
    segments = SEGMENTS if segmented else None
    ref_p, port_p = _int_params(w_bits, segments, a_bits * 10 + w_bits)
    kw = dict(mode="int", w_bits=8 if segmented else w_bits, a_bits=a_bits,
              segments=segments)
    rq, pq = r_layers.QuantConfig(**kw), p_layers.QuantConfig(**kw)
    # activations past the static absmax 4.0 clip; leading dims (B, S)
    x = (np.random.default_rng(a_bits).normal(size=(2, 3, K)) * 2.0).astype(
        np.float32)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        want = r_layers.dense_apply(ref_p, jnp.asarray(x).astype(jdt),
                                    qcfg=rq)
        got = p_layers.dense_apply(port_p, torch.from_numpy(x).to(dtype),
                                   qcfg=pq)
        assert got.dtype == dtype
        assert_same(got, want, f"A{a_bits} {dtype}")


@pytest.mark.parametrize("bits,signed", [(8, True), (4, True), (2, True),
                                         (8, False), (4, False)])
def test_fake_quantize_identical(bits, signed):
    x = (np.random.default_rng(bits).normal(size=(4, 33)) * 3).astype(
        np.float32)
    kw = dict(bits=bits, signed=signed, alpha=-2.5 if signed else 0.0,
              beta=2.5)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        want = r_quant.fake_quantize(jnp.asarray(x).astype(jdt),
                                     r_quant.QuantSpec(**kw))
        got = p_quant.fake_quantize(torch.from_numpy(x).to(dtype),
                                    p_quant.QuantSpec(**kw))
        assert_same(got, want, str(dtype))


@pytest.mark.parametrize("kind", ["rmsnorm", "gemma_rmsnorm", "layernorm",
                                  "nonparam_ln"])
def test_norms_close(kind):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 5, 48)) * 2 + 0.5).astype(np.float32)
    p = {k: rng.normal(size=(48,)).astype(np.float32)
         for k in p_layers.norm_def(48, kind)}
    want = r_layers.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), kind)
    got = p_layers.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL)


def test_rope_functions_close():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 3, 16)).astype(np.float32)
    for theta in (10000.0, 1_000_000.0):
        rc, rs = r_layers.rope_tables(6, 16, theta)
        pc, ps = p_layers.rope_tables(6, 16, theta)
        np.testing.assert_allclose(pc.numpy(), np.asarray(rc), atol=RTOL)
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), atol=RTOL)
        np.testing.assert_allclose(
            p_layers.rope_apply(torch.from_numpy(x), pc, ps).numpy(),
            np.asarray(r_layers.rope_apply(jnp.asarray(x), rc, rs)),
            atol=1e-4)
        pos = np.array([0, 5], np.int32)
        x1 = x[:, :1]
        np.testing.assert_allclose(
            p_layers.rope_apply_at(torch.from_numpy(x1), pc, ps,
                                   torch.from_numpy(pos)).numpy(),
            np.asarray(r_layers.rope_apply_at(jnp.asarray(x1), rc, rs,
                                              jnp.asarray(pos))),
            atol=1e-4)
        for position in (3, pos):
            want = r_layers.rope_single(jnp.asarray(x1), jnp.asarray(
                position), theta)
            got = p_layers.rope_single(torch.from_numpy(x1), torch.as_tensor(
                position), theta)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4)
    # an all-equal position vector gives the scalar's result bit for bit
    same = p_layers.rope_single(torch.from_numpy(x1),
                                torch.tensor([4, 4]), 10000.0)
    assert torch.equal(same, p_layers.rope_single(torch.from_numpy(x1), 4,
                                                  10000.0))


@pytest.mark.parametrize("mode", ["off", "fake"])
def test_dense_apply_float_modes_close(mode):
    w = _weights(5, (K, 96))
    b = np.random.default_rng(6).normal(size=(96,)).astype(np.float32)
    x = np.random.default_rng(7).normal(size=(2, 3, K)).astype(np.float32)
    kw = dict(mode=mode, w_bits=4, a_bits=8)
    want = r_layers.dense_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x),
                                qcfg=r_layers.QuantConfig(**kw))
    got = p_layers.dense_apply({"w": torch.from_numpy(w),
                                "b": torch.from_numpy(b)},
                               torch.from_numpy(x),
                               qcfg=p_layers.QuantConfig(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_embedding_and_dense_defs_match():
    assert p_layers.padded_vocab(151936) == r_layers.padded_vocab(151936)
    table = np.random.default_rng(8).normal(size=(256, 16)).astype(
        np.float32)
    x = np.random.default_rng(9).normal(size=(2, 3, 16)).astype(np.float32)
    want = r_layers.embedding_logits({"table": jnp.asarray(table)},
                                     jnp.asarray(x), vocab=200)
    got = p_layers.embedding_logits({"table": torch.from_numpy(table)},
                                    torch.from_numpy(x), vocab=200)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-5)
    for qkw in (dict(), dict(mode="int", w_bits=4),
                dict(mode="int", w_bits=8, segments=SEGMENTS)):
        rd = r_layers.dense_def(K, N, bias=True,
                                qcfg=r_layers.QuantConfig(**qkw))
        pd = p_layers.dense_def(K, N, bias=True,
                                qcfg=p_layers.QuantConfig(**qkw))
        assert {k: (tuple(d.shape), d.axes, d.init) for k, d in rd.items()} \
            == {k: (tuple(d.shape), d.axes, d.init) for k, d in pd.items()}


def test_int_gemm_output_dtypes_and_refusals():
    """The dense GEMM writes bfloat16 or float32 as asked; only 'dequant'
    takes an out_dtype, and only 'int' needs the epilogue vectors."""
    from repro_torch.core import packing
    from repro_torch.kernels import api
    from repro_torch.kernels.qmatmul import kernel as gemm

    rng = np.random.default_rng(9)
    x_q = torch.from_numpy(rng.integers(-7, 8, (3, 128)).astype(np.int8))
    w = packing.pack(torch.from_numpy(rng.integers(-8, 8, (128, 5)).astype(
        np.int8)), 4, axis=0)
    scale = torch.full((5,), 0.5)
    f32 = api.int_gemm(x_q, w, a_bits=4, w_bits=4, scale=scale,
                       out_dtype=torch.float32)
    bf16 = api.int_gemm(x_q, w, a_bits=4, w_bits=4, scale=scale)
    want = (x_q.int() @ packing.unpack(w, 4, True, axis=0).int()) * 0.5
    assert f32.dtype == torch.float32 and torch.equal(f32, want.float())
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, f32.to(
        torch.bfloat16))
    xp = packing.pack(x_q, 4)
    with pytest.raises(ValueError, match="only 'dequant'"):
        gemm.qmatmul_packed(xp, w, None, None, None, a_bits=4,
                            a_signed=True, w_bits=4, d=0, out_bits=8,
                            epilogue="raw", out_dtype=torch.float32)
    with pytest.raises(ValueError, match="only 'dequant'"):
        api.int_gemm(x_q, w, a_bits=4, w_bits=4, scale=scale,
                     out_dtype=torch.float16)
    with pytest.raises(ValueError, match="epilogue 'int' needs kappa"):
        gemm.epilogue_launch_args(None, None, None, n=5, d=20, out_bits=8,
                                  epilogue="int", scale=1.0,
                                  device=torch.device("cpu"))


def test_dense_int_path_records_no_dispatch_or_counter():
    """As the reference's `xla_int_gemm`, the dense layer's GEMM bypasses
    the op registry: observability on, it records no dispatch event and
    no `qdot` counter; its one call is counted as ``int_gemm`` at the
    dense layer's real K, inside one kernel span."""
    from repro_torch import obs
    from repro_torch.obs import counters

    _, port_p = _int_params(4, None, 3)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, K)).astype(
        np.float32))
    obs.reset()
    obs.enable()
    try:
        p_layers.dense_apply(port_p, x, qcfg=p_layers.QuantConfig(
            mode="int", w_bits=4))
        assert obs.dispatch_log() == []
        (ev,) = obs.spans(cat="kernel")
        assert ev["name"] == "int_gemm"
        (key, bucket), = counters.snapshot().items()
        assert counters.parse_key(key)["op"] == "int_gemm"
        assert bucket["calls"] == 1 and bucket["macs"] == ev["args"]["macs"]
        assert bucket["macs"] == 2 * K * ev["args"]["shape"][2]
    finally:
        obs.disable()
        obs.reset()
