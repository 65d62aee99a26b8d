"""The port's Mamba-2 (`repro_torch.nn.ssm`, `models/mamba.py`) against
the reference's, on the CPU, with the reference's weights carried over as
numpy.

Compute is float32 unless stated. Tolerances, and why:
- the conv, `_segsum`, the SSD scan and the block: 1e-5 x the largest
  output (float32 einsums contracted in another order); the SSD scan
  with bfloat16 operands: 1e-2 x the largest (both sides round the same
  decay factors to bfloat16, but a float32 state may land on the other
  side of a bfloat16 rounding boundary);
- logits: 1e-3 x the largest real logit, decode against forward inside
  the port 2e-2 absolute (as `tests/test_torch_lm.py`).
Exact: every int-mode dense output given the reference's own dense
inputs (captured with its `dense_tap`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.nn import layers as r_layers
from repro.nn import ssm as r_ssm
from repro_torch.nn import layers as p_layers
from repro_torch.nn import ssm as p_ssm

from test_torch_lm import (DECODE_ATOL, LOGIT_RTOL, _models, _real, _t,
                           _tokens)
from torch_bridge import assert_same, fp_numpy, jax_tree

MOD = "mamba2_370m"
RTOL = 1e-5
B = 2


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rtol * np.abs(want).max())


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_causal_conv_dw_and_segsum():
    rng = np.random.default_rng(0)
    u, w = _rand(rng, B, 11, 24), _rand(rng, 4, 24)
    _close(p_ssm._causal_conv_dw(torch.from_numpy(u), torch.from_numpy(w)),
           r_ssm._causal_conv_dw(jnp.asarray(u), jnp.asarray(w)))
    a = -np.abs(_rand(rng, B, 3, 9))
    got = p_ssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(r_ssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    _close(np.where(np.isfinite(got), got, 0),
           np.where(np.isfinite(want), want, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 4])
def test_ssd_chunked(chunk, dtype):
    rng = np.random.default_rng(chunk)
    x, b, c = (_rand(rng, B, 16, 3, 5), _rand(rng, B, 16, 3, 6),
               _rand(rng, B, 16, 3, 6))
    a = -np.abs(_rand(rng, B, 16, 3, scale=0.3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = r_ssm._ssd_chunked(jnp.asarray(x).astype(jd),
                              jnp.asarray(a), jnp.asarray(b).astype(jd),
                              jnp.asarray(c).astype(jd), chunk)
    got = p_ssm._ssd_chunked(torch.from_numpy(x).to(td), torch.from_numpy(a),
                             torch.from_numpy(b).to(td),
                             torch.from_numpy(c).to(td), chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, RTOL if dtype == "float32" else 1e-2)


def _block(seed):
    """(reference cfg, port cfg, port params, reference params): a
    d_model 32 block, chunk 8."""
    kw = dict(d_model=32, d_state=8, headdim=8, chunk=8)
    rc, pc = r_ssm.MambaConfig(**kw), p_ssm.MambaConfig(**kw)
    pp = _t(fp_numpy(p_ssm.mamba_def(pc), seed))
    return rc, pc, pp, jax_tree(pp)


@pytest.mark.parametrize("length", [16, 13], ids=["chunked", "padded"])
def test_mamba_apply_and_decode_match_reference(length):
    rc, pc, pp, rp = _block(length)
    x = _rand(np.random.default_rng(length), B, length, 32)
    _close(p_ssm.mamba_apply(pp, torch.from_numpy(x), pc),
           r_ssm.mamba_apply(rp, jnp.asarray(x), rc))
    r_dec = jax.jit(lambda p, x, c: r_ssm.mamba_decode(p, x, c, rc))
    rcache = r_ssm.mamba_init_cache(rc, B, jnp.float32)
    pcache = p_ssm.mamba_init_cache(pc, B, torch.float32)
    for t in range(length):
        want, rcache = r_dec(rp, jnp.asarray(x[:, t:t + 1]), rcache)
        got, pcache = p_ssm.mamba_decode(pp, torch.from_numpy(
            x[:, t:t + 1]), pcache, pc)
        _close(got, want)
    _close(pcache["ssm"], rcache["ssm"])
    _close(pcache["conv"], rcache["conv"])


@pytest.mark.parametrize("quant", [None, 4], ids=["fp", "w4a8"])
def test_forward_and_decode_match_reference(quant):
    (rm, rp), (pm, pp), _ = _models(MOD, quant)
    vocab = rm.cfg.vocab
    toks = _tokens(vocab, shape=(B, 12))
    want = _real(jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(toks)})[0],
                 vocab)
    got, _, kv = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    assert kv is None
    tol = LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_allclose(_real(got.numpy(), vocab), want, atol=tol)
    r_dec = jax.jit(rm.decode)
    rcache = rm.init_cache(B, 12, jnp.float32)
    pcache = pm.init_cache(B, 12, torch.float32, device="cpu")
    assert pcache["ssm"]["ssm"].dtype == torch.float32
    for t in range(12):
        r_lg, rcache = r_dec(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        p_lg, pcache = pm.decode(pp, pcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_real(p_lg.numpy(), vocab),
                                   _real(r_lg, vocab), atol=tol)


def test_decode_reproduces_forward_in_the_port():
    _, (pm, pp), _ = _models(MOD, 8)
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, seed=2, shape=(B, 12)))
    lf, _, _ = pm.forward(pp, {"tokens": toks})
    cache = pm.init_cache(B, 12, torch.float32, device="cpu")
    errs = []
    for t in range(12):
        lg, cache = pm.decode(pp, cache, toks[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - lf[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL, errs


def test_int_dense_calls_exact_on_reference_inputs():
    """mamba smoke at W4A8, bf16 compute as configured: every dense call
    of the reference's forward and of one decode step, replayed through
    the port's dense_apply, is bit-identical."""
    (rm, rp), _, _ = _models(MOD, 4, compute_dtype="bfloat16")
    calls = []

    def tap(p, x):
        jax.debug.callback(lambda p, x: calls.append((p, x)), p, x)

    toks = jnp.asarray(_tokens(rm.cfg.vocab, shape=(B, 11)))
    with r_layers.dense_tap(tap):
        jax.block_until_ready(jax.jit(rm.forward)(rp, {"tokens": toks}))
        jax.block_until_ready(jax.jit(rm.decode)(
            rp, rm.init_cache(B, 16), toks[:, :1], jnp.int32(0)))
    jax.effects_barrier()
    assert len(calls) == 2 * 2 * rm.cfg.n_layers
    qr = rm.cfg.quant
    qp = p_layers.QuantConfig(mode="int", w_bits=qr.w_bits, a_bits=qr.a_bits)
    r_dense = jax.jit(lambda p, x: r_layers.dense_apply(p, x, qcfg=qr))
    for p, x in calls:
        assert x.dtype == jnp.bfloat16
        got = p_layers.dense_apply(_t(p), torch.from_numpy(np.array(
            x.astype(jnp.float32))).to(torch.bfloat16), qcfg=qp)
        assert_same(got, r_dense(p, x), "dense call")
