"""The port's dense LM (`repro_torch.models`, `nn/attention.py`,
`nn/mlp.py`, `deploy/apply.py`, `launch/convert.py`) against the
reference's, on the CPU, with the reference's weights carried over as
numpy (`repro_torch.convert.fp_params_from_numpy`).

Compute is float32 unless stated. Tolerances, and why:
- attention and MLP blocks: 1e-5 absolute on outputs of order 1 (float32
  einsums and softmax in another rounding order);
- logits: 1e-3 x the largest real logit (float32 drift through a few
  layers; the int path adds only what a flipped activation code at a .5
  boundary moves);
- decode against forward inside the port: 2e-2 absolute, the bound of
  `tests/test_decode_agreement.py`.
Exact: every int-mode dense output given the reference's own dense
inputs (captured with its `dense_tap`), and the packed trees of
`apply_plan` / `convert_params`, uniform and under a ``segments`` plan.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.deploy import apply as r_apply
from repro.deploy import policy as r_policy
from repro.launch import convert as r_convert
from repro.models import api as r_api
from repro.nn import attention as r_attn
from repro.nn import layers as r_layers
from repro.nn import mlp as r_mlp
from repro_torch.convert import fp_params_from_numpy
from repro_torch.deploy import apply as p_apply
from repro_torch.deploy import policy as p_policy
from repro_torch.launch import convert as p_convert
from repro_torch.models import api as p_api
from repro_torch.nn import attention as p_attn
from repro_torch.nn import layers as p_layers
from repro_torch.nn import mlp as p_mlp
from repro_torch.nn.module import param_bytes, param_count

from torch_bridge import assert_same, fp_numpy, jax_tree, np_tree

CONFIGS = ["olmo_1b", "phi3_mini_3p8b", "qwen2p5_3b", "gemma3_1b"]
BLOCK_ATOL = 1e-5
LOGIT_RTOL = 1e-3
DECODE_ATOL = 2e-2
B, S = 2, 8


def _configs(mod, moe=None, **over):
    """Both packages' smoke configs of ``mod`` with ``over`` replaced, and
    a MoE arch's `MoeSpec` fields with ``moe`` (each side keeps its own
    spec class)."""
    over = {"compute_dtype": "float32", **over}
    out = []
    for pkg in ("repro", "repro_torch"):
        c = importlib.import_module(f"{pkg}.configs.{mod}").smoke_config()
        if moe:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
        out.append(dataclasses.replace(c, **over))
    return tuple(out)


def _t(tree):
    return fp_params_from_numpy(np_tree(tree), "cpu")


def _models(mod, quant=None, plan=None, moe=None, **over):
    """(reference model, fp params), (port model, params): numpy fp
    weights on both sides; in int mode the port packs them and the
    reference runs the port's packed tree (the packers are held
    identical by `test_packed_trees_identical_and_serve_exact`)."""
    rc, pc = _configs(mod, moe, **over)
    if quant is not None:
        kw = dict(mode="int", w_bits=quant, a_bits=8)
        rc = dataclasses.replace(
            rc, quant=r_layers.QuantConfig(**kw),
            quant_plan=None if plan is None
            else r_policy.PrecisionPlan.from_json(plan))
        pc = dataclasses.replace(
            pc, quant=p_layers.QuantConfig(**kw),
            quant_plan=None if plan is None
            else p_policy.PrecisionPlan.from_json(plan))
    rm, pm = r_api.build(rc), p_api.build(pc)
    fp = fp_numpy(p_api.build(dataclasses.replace(
        pc, quant=p_layers.QOFF, quant_plan=None)).defs())
    p_fp = _t(fp)
    if quant is None:
        return (rm, jax_tree(p_fp)), (pm, p_fp), fp
    p_q = p_apply.apply_plan(pm.init(0, device="cpu"), p_fp,
                             pm.cfg.quant_plan, quant)
    return (rm, jax_tree(p_q)), (pm, p_q), fp


def _assert_trees_identical(port, ref, path="params"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port), set(ref))
        for k in ref:
            _assert_trees_identical(port[k], ref[k], f"{path}/{k}")
    else:
        assert_same(port, ref, path)


def _tokens(vocab, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, size=shape
                                                ).astype(np.int32)


def _real(logits, vocab):
    return np.asarray(logits, np.float32)[..., :vocab]


# ------------------------------------------------------------- blocks ---

def _attn_cfgs(kv_bits):
    kw = dict(d_model=48, n_heads=4, kv_heads=2, head_dim=16, qkv_bias=True,
              kv_quant_bits=kv_bits)
    return r_attn.AttnConfig(**kw), p_attn.AttnConfig(**kw)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_attention_prefill_and_decode_close(kv_bits):
    rc, pc = _attn_cfgs(kv_bits)
    rng = np.random.default_rng(4)
    rp = {name: {k: jnp.asarray(rng.normal(size=d.shape) * 0.2, jnp.float32)
                 for k, d in dense.items()}
          for name, dense in r_attn.attn_def(rc).items()}
    pp = _t(rp)
    x = np.random.default_rng(5).normal(size=(B, S, 48)).astype(np.float32)
    cos, sin = r_layers.rope_tables(S, 16)
    want, (rk, rv) = r_attn.attn_apply(rp, jnp.asarray(x), rc, cos=cos,
                                       sin=sin, mode="local", window=3)
    pcos, psin = p_layers.rope_tables(S, 16)
    got, (pk, pv) = p_attn.attn_apply(pp, torch.from_numpy(x), pc, cos=pcos,
                                      sin=psin, mode="local", window=3)
    for a, b in ((got, want), (pk, rk), (pv, rv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=BLOCK_ATOL)
    # decode S steps: a scalar index, then a (B,) vector of per-slot
    # positions (slot 1 one step behind)
    r_decode = jax.jit(lambda p, x, c, i: r_attn.attn_decode(
        p, x, c, i, rc, theta=10000.0, mode="local", window=5))
    for vector in (False, True):
        rcache = r_attn.init_cache(rc, B, S, jnp.float32)
        pcache = p_attn.init_cache(pc, B, S, torch.float32)
        for t in range(S):
            idx = np.array([t, max(t - 1, 0)], np.int32) if vector else t
            xt = x[:, t:t + 1]
            want, rcache = r_decode(rp, jnp.asarray(xt), rcache,
                                    jnp.asarray(idx, jnp.int32))
            got, pcache = p_attn.attn_decode(
                pp, torch.from_numpy(xt), pcache,
                torch.from_numpy(idx) if vector else idx, pc, theta=10000.0,
                mode="local", window=5)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=BLOCK_ATOL)
        if kv_bits == 8:
            assert_same(pcache["k"], rcache["k"], "int8 k cache")
    # cross K/V (the prefill's own, as a source of S positions): the
    # cache is neither read nor written
    before = {k: v.clone() for k, v in pcache.items()}
    want, _ = r_attn.attn_decode(rp, jnp.asarray(xt), None, jnp.int32(0),
                                 rc, mode="bidir", cross_kv=(rk, rv))
    got, out = p_attn.attn_decode(pp, torch.from_numpy(xt), pcache, 0, pc,
                                  mode="bidir", cross_kv=(pk, pv))
    assert out is pcache
    assert all(torch.equal(pcache[k], before[k]) for k in before)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_ATOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_close(act):
    rc = r_mlp.MlpConfig(48, 96, act)
    pc = p_mlp.MlpConfig(48, 96, act)
    rng = np.random.default_rng(6)
    rp = {k: {"w": jnp.asarray(rng.normal(size=d["w"].shape) * 0.2,
                               jnp.float32)}
          for k, d in r_mlp.mlp_def(rc).items()}
    x = rng.normal(size=(B, S, 48)).astype(np.float32)
    want = r_mlp.mlp_apply(rp, jnp.asarray(x), rc)
    got = p_mlp.mlp_apply(_t(rp), torch.from_numpy(x), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_ATOL)


# -------------------------------------------------------------- models ---

@pytest.mark.parametrize("quant", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("mod", CONFIGS)
def test_forward_and_decode_match_reference(mod, quant):
    (rm, rp), (pm, pp), _ = _models(mod, quant)
    vocab = rm.cfg.vocab
    toks = _tokens(vocab)
    want = _real(jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(toks)})[0],
                 vocab)
    got, _, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    tol = LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_allclose(_real(got.numpy(), vocab), want, atol=tol)
    r_dec = jax.jit(rm.decode)
    rcache = rm.init_cache(B, S, jnp.float32)
    pcache = pm.init_cache(B, S, torch.float32, device="cpu")
    for t in range(S):
        r_lg, rcache = r_dec(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        p_lg, pcache = pm.decode(pp, pcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_real(p_lg.numpy(), vocab),
                                   _real(r_lg, vocab), atol=tol)


@pytest.mark.parametrize("mod", CONFIGS)
def test_decode_reproduces_forward_in_the_port(mod):
    _, (pm, pp), _ = _models(mod, 8)
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, seed=2, shape=(B, 12)))
    lf, _, _ = pm.forward(pp, {"tokens": toks})
    cache = pm.init_cache(B, 12, torch.float32, device="cpu")
    errs = []
    for t in range(12):
        lg, cache = pm.decode(pp, cache, toks[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - lf[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL, errs


def test_int_dense_calls_exact_on_reference_inputs():
    """qwen smoke at W4A8, bf16 compute as configured: every dense call of
    the reference's (jitted) forward, captured by its dense_tap through a
    debug callback and replayed through the port's dense_apply on the
    same params and inputs, is bit-identical."""
    (rm, rp), _, _ = _models("qwen2p5_3b", 4, compute_dtype="bfloat16")
    calls = []

    def tap(p, x):
        jax.debug.callback(lambda p, x: calls.append((p, x)), p, x)

    with r_layers.dense_tap(tap):
        jax.block_until_ready(jax.jit(rm.forward)(
            rp, {"tokens": jnp.asarray(_tokens(rm.cfg.vocab))}))
    jax.effects_barrier()
    assert len(calls) == 7 * rm.cfg.n_layers
    qr = rm.cfg.quant
    qp = p_layers.QuantConfig(mode="int", w_bits=qr.w_bits, a_bits=qr.a_bits)
    r_dense = jax.jit(lambda p, x: r_layers.dense_apply(p, x, qcfg=qr))
    for p, x in calls:
        assert x.dtype == jnp.bfloat16
        got = p_layers.dense_apply(_t(p), torch.from_numpy(np.array(
            x.astype(jnp.float32))).to(torch.bfloat16), qcfg=qp)
        assert_same(got, r_dense(p, x), "dense call")


# half of every layers/mlp/wi at W8, half at W4 (qwen smoke at d_ff 256)
SEG_PLAN = (
    '{"version": 4, "default": {"w_bits": 8, "a_bits": 8}, "rules": ['
    '{"pattern": "layers/mlp/wi", "w_bits": 8, "a_bits": 8, '
    '"segments": [[0, 128, 8], [128, 256, 4]]}, '
    '{"pattern": "layers/attn/w*", "w_bits": 2, "a_bits": 8}]}')


@pytest.mark.parametrize("plan", [None, SEG_PLAN],
                         ids=["uniform", "segments"])
def test_packed_trees_identical_and_serve_exact(plan):
    (rm, _), (pm, pp), fp = _models("qwen2p5_3b", 4, plan=plan, d_ff=256)
    r_fp = np_tree(fp)
    # eager, as the reference's converter runs (its range guard armed)
    rp = r_apply.apply_plan(jax.jit(rm.init)(jax.random.PRNGKey(0)), r_fp,
                            rm.cfg.quant_plan, 4)
    _assert_trees_identical(pp, rp)
    assert param_bytes(pp) == r_convert.artifact_bytes(rp)
    assert param_count(pp) == sum(a.size for a in jax.tree.leaves(rp))
    paths = p_apply.quantized_dense_paths(pm.defs())
    assert paths == r_apply.quantized_dense_paths(rm.defs())
    assert p_apply.dense_inventory(_t(fp), paths) == \
        r_apply.dense_inventory(r_fp, paths)
    if plan is None:
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


def test_other_families_raise_naming_the_roadmap():
    cfg = p_api.get_smoke_config("qwen2.5-3b")
    # the enc-dec family is served now: a build of it has its trees
    defs = p_api.build(p_api.get_smoke_config(
        "seamless-m4t-large-v2")).defs()
    assert {"enc_layers", "dec_layers", "enc_norm"} <= set(defs)
    # and so are MoE layers: a moe block in place of the mlp one
    defs = p_api.build(dataclasses.replace(
        cfg, moe=importlib.import_module(
            "repro_torch.configs.base").MoeSpec(4, 2, 64))).defs()
    assert "moe" in defs["layers"] and "mlp" not in defs["layers"]
    assert defs["layers"]["moe"]["wi"].shape == (2, 4, 64, 64)
    with pytest.raises(NotImplementedError, match="not in the reference"):
        p_api.build(dataclasses.replace(cfg, family="diffusion"))
    assert r_api.list_archs() == [
        "gemma3-1b", "kimi-k2-1t-a32b", "llama-3.2-vision-90b",
        "llama4-maverick-400b-a17b", "mamba2-370m", "olmo-1b",
        "phi3-mini-3.8b", "qwen2.5-3b", "recurrentgemma-9b",
        "seamless-m4t-large-v2"]
    # the port adds Kimi-K2-Instruct's published block
    assert p_api.list_archs() == sorted(r_api.list_archs()
                                        + ["kimi-k2-instruct"])
    # the published numbers and the smoke configs, copied unchanged (a
    # MoeSpec field by field: the two packages' classes differ); the
    # fields only the port has (latent attention, leading dense layers,
    # YaRN, the dropless dispatch) keep their defaults there
    for name in r_api.list_archs():
        for r, p in ((r_api.get_config(name), p_api.get_config(name)),
                     (r_api.get_smoke_config(name),
                      p_api.get_smoke_config(name))):
            for f in dataclasses.fields(p):
                if f.name in ("quant", "quant_plan"):
                    continue
                a = getattr(p, f.name)
                if not hasattr(r, f.name):
                    assert a == f.default, (name, f.name)
                    continue
                b = getattr(r, f.name)
                if f.name == "moe" and a is not None:
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                    for k in set(a) - set(b):
                        assert a.pop(k) == next(
                            g.default for g in dataclasses.fields(
                                p.moe) if g.name == k), (name, k)
                assert a == b, (name, f.name)
