"""The port's Griffin / RecurrentGemma (`repro_torch.nn.rglru`, the ring
KV cache of `nn/attention.py`, `models/griffin.py`) against the
reference's, on the CPU, with the reference's weights carried over as
numpy; and the packed trees of both recurrent families.

Compute is float32 unless stated. Tolerances, and why:
- the RG-LRU block: 1e-5 x the largest output (the port runs the
  recurrence as a loop over positions, the reference as an associative
  scan: the same products composed in another order);
- ring-cache attention: 1e-5 absolute on outputs of order 1, as the
  other attention blocks (`tests/test_torch_lm.py`);
- logits: 1e-3 x the largest real logit; decode against forward inside
  the port 2e-2 absolute.
Exact: every int-mode dense output given the reference's own dense
inputs, and the packed trees of `apply_plan` / `convert_params`, uniform
and under a ``segments`` plan, for mamba-smoke and rgemma-smoke.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.deploy import apply as r_apply
from repro.launch import convert as r_convert
from repro.nn import attention as r_attn
from repro.nn import layers as r_layers
from repro.nn import rglru as r_rglru
from repro_torch.deploy import apply as p_apply
from repro_torch.launch import convert as p_convert
from repro_torch.nn import attention as p_attn
from repro_torch.nn import layers as p_layers
from repro_torch.nn import rglru as p_rglru
from repro_torch.nn.module import param_bytes, param_count

from test_torch_lm import (BLOCK_ATOL, DECODE_ATOL, LOGIT_RTOL,
                           _assert_trees_identical, _models, _real, _t,
                           _tokens)
from torch_bridge import assert_same, fp_numpy, jax_tree, np_tree

MOD = "recurrentgemma_9b"
B = 2


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rtol * np.abs(want).max())


def test_rglru_block_apply_and_decode_match_reference():
    rc = r_rglru.RglruConfig(32, 48)
    pc = p_rglru.RglruConfig(32, 48)
    pp = _t(fp_numpy(p_rglru.rglru_block_def(pc), 3))
    rp = jax_tree(pp)
    x = np.random.default_rng(3).normal(size=(B, 13, 32)).astype(np.float32)
    _close(p_rglru.rglru_block_apply(pp, torch.from_numpy(x), pc),
           r_rglru.rglru_block_apply(rp, jnp.asarray(x), rc))
    r_dec = jax.jit(lambda p, x, c: r_rglru.rglru_block_decode(p, x, c, rc))
    rcache = r_rglru.rglru_init_cache(rc, B, jnp.float32)
    pcache = p_rglru.rglru_init_cache(pc, B, torch.float32)
    for t in range(13):
        want, rcache = r_dec(rp, jnp.asarray(x[:, t:t + 1]), rcache)
        got, pcache = p_rglru.rglru_block_decode(
            pp, torch.from_numpy(x[:, t:t + 1]), pcache, pc)
        _close(got, want)
    _close(pcache["h"], rcache["h"])
    _close(pcache["conv"], rcache["conv"])


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_ring_cache_decode_past_a_wrap(vector, kv_bits):
    """Window 8 over an 8-slot ring, 20 steps: every slot is rewritten
    twice. The vector form keeps slot 1 three steps behind, so its row
    wraps at other steps."""
    kw = dict(d_model=48, n_heads=4, kv_heads=1, head_dim=16,
              kv_quant_bits=kv_bits)
    rc, pc = r_attn.AttnConfig(**kw), p_attn.AttnConfig(**kw)
    rng = np.random.default_rng(7)
    rp = {name: {k: jnp.asarray(rng.normal(size=d.shape) * 0.2, jnp.float32)
                 for k, d in dense.items()}
          for name, dense in r_attn.attn_def(rc).items()}
    pp = _t(rp)
    x = rng.normal(size=(B, 20, 48)).astype(np.float32)
    r_dec = jax.jit(lambda p, x, c, i: r_attn.attn_decode(
        p, x, c, i, rc, mode="local", window=8, ring=True))
    rcache = r_attn.init_cache(rc, B, 8, jnp.float32)
    pcache = p_attn.init_cache(pc, B, 8, torch.float32)
    for t in range(20):
        idx = np.array([t, max(t - 3, 0)], np.int32) if vector else t
        want, rcache = r_dec(rp, jnp.asarray(x[:, t:t + 1]), rcache,
                             jnp.asarray(idx, jnp.int32))
        got, pcache = p_attn.attn_decode(
            pp, torch.from_numpy(x[:, t:t + 1]), pcache,
            torch.from_numpy(idx) if vector else idx, pc, mode="local",
            window=8, ring=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BLOCK_ATOL)
    for k in ("k", "v"):
        if kv_bits == 8:
            assert_same(pcache[k], rcache[k], f"int8 {k} ring")
        else:
            np.testing.assert_allclose(pcache[k].numpy(),
                                       np.asarray(rcache[k]), atol=BLOCK_ATOL)
    # cross K/V beside a ring cache: every source position, whatever the
    # index, and the ring neither read nor written
    src = rng.normal(size=(B, 5, 48)).astype(np.float32)
    rk, rv = r_attn.cross_kv_project(rp, jnp.asarray(src), rc)
    pk, pv = p_attn.cross_kv_project(pp, torch.from_numpy(src), pc)
    before = {k: v.clone() for k, v in pcache.items()}
    idx = np.array([19, 16], np.int32) if vector else 19
    want, _ = r_attn.attn_decode(rp, jnp.asarray(x[:, :1]), None,
                                 jnp.asarray(idx), rc, mode="bidir",
                                 cross_kv=(rk, rv))
    got, out = p_attn.attn_decode(
        pp, torch.from_numpy(x[:, :1]), pcache,
        torch.from_numpy(idx) if vector else idx, pc, mode="bidir",
        cross_kv=(pk, pv), ring=True)
    assert out is pcache
    assert all(torch.equal(pcache[k], before[k]) for k in before)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_ATOL)


@pytest.mark.parametrize("quant", [None, 4], ids=["fp", "w4a8"])
def test_forward_and_decode_match_reference(quant):
    """rgemma smoke (window 8) over 12 positions, so the decode ring
    wraps."""
    (rm, rp), (pm, pp), _ = _models(MOD, quant)
    vocab = rm.cfg.vocab
    toks = _tokens(vocab, shape=(B, 12))
    want = _real(jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(toks)})[0],
                 vocab)
    got, _, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    tol = LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_allclose(_real(got.numpy(), vocab), want, atol=tol)
    r_dec = jax.jit(rm.decode)
    rcache = rm.init_cache(B, 12, jnp.float32)
    pcache = pm.init_cache(B, 12, torch.float32, device="cpu")
    assert pcache["kv"]["k"].shape[2] == rm.cfg.window
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
        lg, cache = pm.decode(pp, cache, toks[:, t:t + 1],
                              torch.tensor([t, t]))
        errs.append(float((lg[:, 0] - lf[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL, errs


def test_int_dense_calls_exact_on_reference_inputs():
    """rgemma smoke at W4A8, bf16 compute as configured: every dense call
    of the reference's forward (6 rec layers x 8 + 2 attention layers x
    7), replayed through the port's dense_apply, is bit-identical."""
    (rm, rp), _, _ = _models(MOD, 4, compute_dtype="bfloat16")
    calls = []

    def tap(p, x):
        jax.debug.callback(lambda p, x: calls.append((p, x)), p, x)

    with r_layers.dense_tap(tap):
        jax.block_until_ready(jax.jit(rm.forward)(
            rp, {"tokens": jnp.asarray(_tokens(rm.cfg.vocab))}))
    jax.effects_barrier()
    assert len(calls) == 6 * 8 + 2 * 7
    qr = rm.cfg.quant
    qp = p_layers.QuantConfig(mode="int", w_bits=qr.w_bits, a_bits=qr.a_bits)
    r_dense = jax.jit(lambda p, x: r_layers.dense_apply(p, x, qcfg=qr))
    for p, x in calls:
        assert x.dtype == jnp.bfloat16
        got = p_layers.dense_apply(_t(p), torch.from_numpy(np.array(
            x.astype(jnp.float32))).to(torch.bfloat16), qcfg=qp)
        assert_same(got, r_dense(p, x), "dense call")


# mamba smoke: in_proj (N 296) split W8 | W4, out_proj at W2; rgemma
# smoke at d_ff 256: every rec_layers/mlp/wi split W8 | W4, the attention
# projections at W2, the rest at the default
SEG_PLANS = {
    "mamba2_370m": (
        '{"version": 4, "default": {"w_bits": 8, "a_bits": 8}, "rules": ['
        '{"pattern": "layers/mixer/in_proj", "w_bits": 8, "a_bits": 8, '
        '"segments": [[0, 128, 8], [128, 296, 4]]}, '
        '{"pattern": "layers/mixer/out_proj", "w_bits": 2, "a_bits": 8}]}'),
    "recurrentgemma_9b": (
        '{"version": 4, "default": {"w_bits": 8, "a_bits": 8}, "rules": ['
        '{"pattern": "rec_layers/mlp/wi", "w_bits": 8, "a_bits": 8, '
        '"segments": [[0, 128, 8], [128, 256, 4]]}, '
        '{"pattern": "attn_layers/attn/w*", "w_bits": 2, "a_bits": 8}]}'),
}
PATHS = {
    "mamba2_370m": ("layers/mixer/in_proj", "layers/mixer/out_proj"),
    "recurrentgemma_9b": tuple(
        f"attn_layers/{b}/{n}" for b, ns in (
            ("attn", ("wk", "wo", "wq", "wv")), ("mlp", ("wg", "wi", "wo")))
        for n in ns) + tuple(
        f"rec_layers/{b}/{n}" for b, ns in (
            ("mlp", ("wg", "wi", "wo")),
            ("rec", ("in_gate", "in_x", "out", "w_a", "w_i")))
        for n in ns),
}


@pytest.mark.parametrize("plan", [False, True], ids=["uniform", "segments"])
@pytest.mark.parametrize("mod", ["mamba2_370m", MOD])
def test_packed_trees_identical_and_serve_exact(mod, plan):
    over = {"d_ff": 256} if mod == MOD else {}
    (rm, _), (pm, pp), fp = _models(mod, 4, plan=SEG_PLANS[mod] if plan
                                    else None, **over)
    r_fp = np_tree(fp)
    # eager, as the reference's converter runs (its range guard armed)
    rp = r_apply.apply_plan(jax.jit(rm.init)(jax.random.PRNGKey(0)), r_fp,
                            rm.cfg.quant_plan, 4)
    _assert_trees_identical(pp, rp)
    assert param_bytes(pp) == r_convert.artifact_bytes(rp)
    assert param_count(pp) == sum(a.size for a in jax.tree.leaves(rp))
    paths = p_apply.quantized_dense_paths(pm.defs())
    assert paths == r_apply.quantized_dense_paths(rm.defs()) == PATHS[mod]
    assert p_apply.dense_inventory(_t(fp), paths) == \
        r_apply.dense_inventory(r_fp, paths)
    if not plan:
        # the uniform converter is apply_plan without a plan
        _assert_trees_identical(
            p_convert.convert_params(pm.init(0, device="cpu"), _t(fp), 4),
            rp)
    toks = _tokens(rm.cfg.vocab, seed=3)
    got, _, _ = pm.forward(_t(rp), {"tokens": torch.from_numpy(toks)})
    want, _, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(got, want)
    ref = _real(jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(toks)})[0],
                rm.cfg.vocab)
    np.testing.assert_allclose(_real(got.numpy(), rm.cfg.vocab), ref,
                               atol=LOGIT_RTOL * np.abs(ref).max())
