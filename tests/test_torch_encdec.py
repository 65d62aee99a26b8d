"""Cross attention in the port (`nn/attention.py`'s cross path and
`cross_kv_project`, `models/encdec.py`, llama-3.2-vision's cross layers
in `models/lm.py`) against the reference's, on the CPU, with the
reference's weights carried over as numpy; and the enc-dec and vision
archs served (`Engine`, `repro_torch.launch.serve`).

seamless-smoke (2 encoder + 2 decoder layers) and vision-smoke (4 self
layers + 1 cross layer), source embeddings of 16 positions drawn from a
seed. Compute is float32 unless stated. Tolerances, and why (those of
`tests/test_torch_lm.py`):
- attention blocks and `encode`: 1e-5 absolute on outputs of order 1
  (float32 einsums, softmax and layer norms in another rounding order);
- logits: 1e-3 x the largest real logit (float32 drift through a few
  layers; the int path adds only what a flipped activation code at a .5
  boundary moves);
- decode against forward inside the port, the cross cache filled from
  `encode` (seamless) or the embeddings (vision): 2e-2 absolute, the
  bound of `tests/test_decode_agreement.py`;
- served W4A8 (bf16 compute) logits: 0.1, as `tests/test_torch_lm_serve.py`,
  with greedy tokens equal where the reference's top-1 margin exceeds it.
Exact: every int-mode dense output given the reference's own dense
inputs (its `dense_tap`), and the packed trees, uniform and under a
``segments`` plan on ``dec_layers/mlp/wi`` / ``cross_layers/mlp/wi``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.deploy import apply as r_apply
from repro.launch import convert as r_convert
from repro.models import api as r_api
from repro.models import encdec as r_encdec
from repro.models import lm as r_lm
from repro.nn import attention as r_attn
from repro.nn import layers as r_layers
from repro.serve import engine as r_engine
from repro_torch.convert import fp_params_from_numpy
from repro_torch.deploy import apply as p_apply
from repro_torch.launch import convert as p_convert
from repro_torch.launch import serve as p_serve
from repro_torch.models import api as p_api
from repro_torch.models import encdec as p_encdec
from repro_torch.nn import attention as p_attn
from repro_torch.nn import layers as p_layers
from repro_torch.nn.module import param_bytes, param_count
from repro_torch.serve import engine as p_engine

from test_torch_lm import (BLOCK_ATOL, DECODE_ATOL, LOGIT_RTOL,
                           _assert_trees_identical, _models, _real, _t,
                           _tokens)
from test_torch_lm_serve import QUANT, TOL, _generate, _prompts
from torch_bridge import assert_same, fp_numpy, jax_tree, np_tree

MODS = ["seamless_m4t_large_v2", "llama3p2_vision_90b"]
ARCHS = ["seamless-m4t-large-v2", "llama-3.2-vision-90b"]
B, S = 2, 12


def _src(cfg, seed=9):
    return (np.random.default_rng(seed).normal(
        size=(B, cfg.src_len, cfg.d_model)) * 0.5).astype(np.float32)


def _batch(toks, src, jax_side):
    if jax_side:
        return {"tokens": jnp.asarray(toks), "src_embed": jnp.asarray(src)}
    return {"tokens": torch.from_numpy(toks),
            "src_embed": torch.from_numpy(src)}


def _ref_cross_kv(rm, rp, src):
    """The reference's cross cache for ``src``, filled as
    tests/test_decode_agreement.py fills it, through the projection the
    reference's forward uses (``dec_layers/xattn`` or
    ``cross_layers/xattn``)."""
    cfg = rm.cfg
    if cfg.family == "encdec":
        states = r_encdec.encode(rp, jnp.asarray(src), cfg)
        stack, n, path = rp["dec_layers"], cfg.dec_layers, "dec_layers"
    else:
        states = jnp.asarray(src).astype(jnp.float32)
        stack, n, path = rp["cross_layers"], r_lm._layer_split(cfg)[1], \
            "cross_layers"
    acfg = r_lm._attn_cfg(cfg, f"{path}/xattn")
    return jnp.stack([jnp.stack(r_attn.cross_kv_project(
        jax.tree.map(lambda a: a[i], stack)["xattn"], states, acfg))
        for i in range(n)])


# ------------------------------------------------------------- blocks ---

@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_cross_attention_and_projection_match_reference(vector):
    kw = dict(d_model=48, n_heads=4, kv_heads=2, head_dim=16)
    rc, pc = r_attn.AttnConfig(**kw), p_attn.AttnConfig(**kw)
    rng = np.random.default_rng(4)
    rp = {name: {k: jnp.asarray(rng.normal(size=d.shape) * 0.2, jnp.float32)
                 for k, d in dense.items()}
          for name, dense in r_attn.attn_def(rc).items()}
    pp = _t(rp)
    x = rng.normal(size=(B, S, 48)).astype(np.float32)
    src = rng.normal(size=(B, 10, 48)).astype(np.float32)
    rk, rv = r_attn.cross_kv_project(rp, jnp.asarray(src), rc)
    pk, pv = p_attn.cross_kv_project(pp, torch.from_numpy(src), pc)
    for a, b in ((pk, rk), (pv, rv)):
        assert a.shape == (B, 10, 2, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BLOCK_ATOL)
    want, _ = r_attn.attn_apply(rp, jnp.asarray(x), rc, cos=None, sin=None,
                                mode="bidir", cross_kv=(rk, rv))
    got, (gk, gv) = p_attn.attn_apply(pp, torch.from_numpy(x), pc, cos=None,
                                      sin=None, mode="bidir",
                                      cross_kv=(pk, pv))
    assert gk is pk and gv is pv
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_ATOL)
    # one query at a time: every source position whatever the index (a
    # scalar, or a (B,) vector with slot 1 three steps behind), no cache
    for t in range(S):
        idx = np.array([t, max(t - 3, 0)], np.int32) if vector else t
        want_t, _ = r_attn.attn_decode(
            rp, jnp.asarray(x[:, t:t + 1]), None, jnp.asarray(idx), rc,
            mode="bidir", cross_kv=(rk, rv))
        got_t, cache = p_attn.attn_decode(
            pp, torch.from_numpy(x[:, t:t + 1]), None,
            torch.from_numpy(idx) if vector else idx, pc, mode="bidir",
            cross_kv=(pk, pv))
        assert cache is None
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   atol=BLOCK_ATOL)
        np.testing.assert_allclose(got_t.numpy(), got[:, t:t + 1].numpy(),
                                   atol=BLOCK_ATOL)


def test_encode_matches_reference():
    (rm, rp), (pm, pp), _ = _models(MODS[0])
    src = _src(rm.cfg)
    want = r_encdec.encode(rp, jnp.asarray(src), rm.cfg)
    got = p_encdec.encode(pp, torch.from_numpy(src), pm.cfg)
    assert got.shape == (B, rm.cfg.src_len, rm.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=BLOCK_ATOL)


# -------------------------------------------------------------- models ---

@pytest.mark.parametrize("quant", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("mod", MODS)
def test_forward_and_decode_match_reference(mod, quant):
    """The teacher-forced forward, then each decode step over the cross
    cache each side fills from its own source states."""
    (rm, rp), (pm, pp), _ = _models(mod, quant)
    vocab = rm.cfg.vocab
    toks, src = _tokens(vocab, shape=(B, S)), _src(rm.cfg)
    want = _real(jax.jit(rm.forward)(rp, _batch(toks, src, True))[0], vocab)
    got, _, kvs = pm.forward(pp, _batch(toks, src, False))
    assert kvs is None
    tol = LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_allclose(_real(got.numpy(), vocab), want, atol=tol)
    rcache = rm.init_cache(B, S, jnp.float32)
    rcache["cross_kv"] = _ref_cross_kv(rm, rp, src)
    pcache = pm.fill_cross_kv(pp, pm.init_cache(B, S, torch.float32,
                                                device="cpu"),
                              torch.from_numpy(src))
    np.testing.assert_allclose(pcache["cross_kv"].numpy(),
                               np.asarray(rcache["cross_kv"]),
                               atol=BLOCK_ATOL)
    r_dec = jax.jit(rm.decode)
    for t in range(S):
        r_lg, rcache = r_dec(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        p_lg, pcache = pm.decode(pp, pcache, torch.from_numpy(
            toks[:, t:t + 1]), t)
        np.testing.assert_allclose(_real(p_lg.numpy(), vocab),
                                   _real(r_lg, vocab), atol=tol)


@pytest.mark.parametrize("quant", [None, 8], ids=["fp", "w8a8"])
@pytest.mark.parametrize("mod", MODS)
def test_decode_with_filled_cross_cache_reproduces_forward(mod, quant):
    """tests/test_decode_agreement.py in the port: the cross cache filled
    from `encode` (seamless) or the embeddings (vision), 12 steps against
    the teacher-forced forward; a (B,) vector of equal positions gives
    the scalar's logits bit for bit."""
    _, (pm, pp), _ = _models(mod, quant)
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, seed=2, shape=(B, S)))
    src = torch.from_numpy(_src(pm.cfg, seed=3))
    lf, _, _ = pm.forward(pp, {"tokens": toks, "src_embed": src})
    caches = [pm.fill_cross_kv(pp, pm.init_cache(B, S, torch.float32,
                                                 device="cpu"), src)
              for _ in range(2)]
    errs = []
    for t in range(S):
        lg, _ = pm.decode(pp, caches[0], toks[:, t:t + 1], t)
        lv, _ = pm.decode(pp, caches[1], toks[:, t:t + 1],
                          torch.full((B,), t))
        assert torch.equal(lg, lv), t
        errs.append(float((lg[:, 0] - lf[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL, errs


def _dense_calls_per_forward(cfg):
    if cfg.family == "encdec":     # enc: 4 + 2; dec: 4 + wk wv wq wo + 2
        return 6 * cfg.enc_layers + 10 * cfg.dec_layers
    n_self, n_cross = r_lm._layer_split(cfg)
    return 7 * n_self + 7 * n_cross    # swiglu: 3 mlp denses; + the head


@pytest.mark.parametrize("mod", MODS)
def test_int_dense_calls_exact_on_reference_inputs(mod):
    """W4A8, bf16 compute as configured: every dense call of the
    reference's (jitted) forward, captured by its dense_tap through a
    debug callback and replayed through the port's dense_apply on the
    same params and inputs, is bit-identical."""
    (rm, rp), _, _ = _models(mod, 4, compute_dtype="bfloat16")
    calls = []

    def tap(p, x):
        jax.debug.callback(lambda p, x: calls.append((p, x)), p, x)

    toks, src = _tokens(rm.cfg.vocab), _src(rm.cfg)
    with r_layers.dense_tap(tap):
        jax.block_until_ready(jax.jit(rm.forward)(rp, _batch(toks, src,
                                                             True)))
    jax.effects_barrier()
    # the untied head (vision) is a float dense, outside the int path
    calls = [(p, x) for p, x in calls if "w_packed" in p]
    assert len(calls) == _dense_calls_per_forward(rm.cfg)
    qr = rm.cfg.quant
    qp = p_layers.QuantConfig(mode="int", w_bits=qr.w_bits, a_bits=qr.a_bits)
    r_dense = jax.jit(lambda p, x: r_layers.dense_apply(p, x, qcfg=qr))
    for p, x in calls:
        assert x.dtype == jnp.bfloat16
        got = p_layers.dense_apply(_t(p), torch.from_numpy(np.array(
            x.astype(jnp.float32))).to(torch.bfloat16), qcfg=qp)
        assert_same(got, r_dense(p, x), "dense call")


def test_bfloat16_param_tree_packs_and_serves_exact():
    """llama-3.2-vision-90b's param_dtype is bfloat16, so its w_scale is
    bfloat16: the packed tree equals the reference's, and every int dense
    call of the reference's (jitted) forward replays bit for bit (the
    dequant scale meets a_scale rounded to bfloat16 and multiplies in
    float32, as the compiled reference does; the port's CPU and card
    paths each rounded it another way before)."""
    (rm, _), (pm, _), fp = _models(MODS[1], 4, param_dtype="bfloat16",
                                   compute_dtype="bfloat16")

    def bf16(tree, to):
        return {k: bf16(v, to) if isinstance(v, dict) else to(v)
                for k, v in tree.items()}

    pp = p_apply.apply_plan(pm.init(0, device="cpu"), bf16(
        _t(fp), lambda t: t.to(torch.bfloat16)), None, 4)
    rp = r_apply.apply_plan(jax.jit(rm.init)(jax.random.PRNGKey(0)), bf16(
        np_tree(fp), lambda a: jnp.asarray(a, jnp.bfloat16)), None, 4)
    _assert_trees_identical(pp, rp)
    assert pp["layers"]["attn"]["wq"]["w_scale"].dtype == torch.bfloat16
    calls = []

    def tap(p, x):
        jax.debug.callback(lambda p, x: calls.append((p, x)), p, x)

    with r_layers.dense_tap(tap):
        jax.block_until_ready(jax.jit(rm.forward)(rp, _batch(
            _tokens(rm.cfg.vocab), _src(rm.cfg), True)))
    jax.effects_barrier()
    calls = [(p, x) for p, x in calls if "w_packed" in p]
    assert len(calls) == _dense_calls_per_forward(rm.cfg)
    qr = rm.cfg.quant
    qp = p_layers.QuantConfig(mode="int", w_bits=qr.w_bits, a_bits=qr.a_bits)
    r_dense = jax.jit(lambda p, x: r_layers.dense_apply(p, x, qcfg=qr))
    for p, x in calls:
        got = p_layers.dense_apply(
            {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
                torch.bfloat16) if v.dtype == jnp.bfloat16 else _t(v)
             for k, v in p.items()},
            torch.from_numpy(np.array(x.astype(jnp.float32))).to(
                torch.bfloat16), qcfg=qp)
        assert_same(got, r_dense(p, x), "dense call")


def _seg_plan(stack):
    # half of every <stack>/mlp/wi at W8, half at W4 (smoke d_ff 256);
    # the self-attention projections at W2
    attn = "dec_layers/attn/w*" if stack == "dec_layers" \
        else "layers/attn/w*"
    return (
        '{"version": 4, "default": {"w_bits": 8, "a_bits": 8}, "rules": ['
        f'{{"pattern": "{stack}/mlp/wi", "w_bits": 8, "a_bits": 8, '
        '"segments": [[0, 128, 8], [128, 256, 4]]}, '
        f'{{"pattern": "{attn}", "w_bits": 2, "a_bits": 8}}]}}')


@pytest.mark.parametrize("segments", [False, True],
                         ids=["uniform", "segments"])
@pytest.mark.parametrize("mod", MODS)
def test_packed_trees_identical_and_serve_exact(mod, segments):
    stack = "dec_layers" if mod == MODS[0] else "cross_layers"
    plan = _seg_plan(stack) if segments else None
    (rm, _), (pm, pp), fp = _models(mod, 4, plan=plan, d_ff=256)
    r_fp = np_tree(fp)
    rp = r_apply.apply_plan(jax.jit(rm.init)(jax.random.PRNGKey(0)), r_fp,
                            rm.cfg.quant_plan, 4)
    _assert_trees_identical(pp, rp)
    assert param_bytes(pp) == r_convert.artifact_bytes(rp)
    assert param_count(pp) == sum(a.size for a in jax.tree.leaves(rp))
    paths = p_apply.quantized_dense_paths(pm.defs())
    assert paths == r_apply.quantized_dense_paths(rm.defs())
    assert f"{stack}/xattn/wk" in paths
    assert p_apply.dense_inventory(_t(fp), paths) == \
        r_apply.dense_inventory(r_fp, paths)
    if plan is None:
        _assert_trees_identical(
            p_convert.convert_params(pm.init(0, device="cpu"), _t(fp), 4),
            rp)
    toks, src = _tokens(rm.cfg.vocab, seed=3), _src(rm.cfg, seed=4)
    got, _, _ = pm.forward(_t(rp), _batch(toks, src, False))
    want, _, _ = pm.forward(pp, _batch(toks, src, False))
    assert torch.equal(got, want)
    ref = _real(jax.jit(rm.forward)(rp, _batch(toks, src, True))[0],
                rm.cfg.vocab)
    np.testing.assert_allclose(_real(got.numpy(), rm.cfg.vocab), ref,
                               atol=LOGIT_RTOL * np.abs(ref).max())


# ------------------------------------------------------------- serving ---

@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """(reference model, params), (port model, params) at smoke W4A8, bf16
    compute: the port packs the numpy weights (the embedding table scaled
    by 0.1), the reference serves those bytes."""
    base = p_api.get_smoke_config(request.param)
    fp = fp_numpy(p_api.build(base).defs())
    fp["embed"]["table"] *= 0.1
    pm = p_api.build(dataclasses.replace(
        base, quant=p_layers.QuantConfig(**QUANT)))
    pp = p_convert.convert_params(pm.init(0, device="cpu"),
                                  fp_params_from_numpy(fp, "cpu"), 4)
    rm = r_api.build(dataclasses.replace(
        r_api.get_smoke_config(request.param),
        quant=r_layers.QuantConfig(**QUANT)))
    return (rm, jax_tree(pp)), (pm, pp)


def test_engine_tokens_match_reference_engine(served):
    """Both engines leave the cross cache at zero (no serving entry point
    takes ``src_embed``); 6 requests on 4 slots. The smoke rows are flat
    (median top-1 margin about 0.2), so histories may part early: 10
    (seamless) and 12 (vision) tokens are compared, and at least one per
    request must be."""
    (rm, rp), (pm, pp) = served
    prompts = _prompts()
    want, r_rows = _generate(r_engine.Engine(rm, rp, 4, 32),
                             r_engine.Request, prompts)
    got, p_rows = _generate(p_engine.Engine(pm, pp, 4, 32, device="cpu"),
                            p_engine.Request, prompts)
    vocab = rm.cfg.vocab
    compared = 0
    for w, g, rr, pr in zip(want, got, r_rows, p_rows):
        assert len(g) == len(w)
        for k, (a, b) in enumerate(zip(w.tolist(), g.tolist())):
            np.testing.assert_allclose(pr[k][:vocab], rr[k][:vocab],
                                       atol=TOL)
            top2 = np.sort(rr[k][:vocab])[-2:]
            if top2[1] - top2[0] <= TOL:
                break               # a near tie: histories may part here
            assert a == b, (k, w, g)
            compared += 1
    assert compared >= len(prompts)


def test_cross_cache_is_positional_not_reset(served):
    """The cross cache has its slot axis at 2, and slot reuse leaves it
    alone: only the recurrent families' carried state is cleared."""
    _, (pm, pp) = served
    adapter = p_engine.Engine(pm, pp, 3, 16, device="cpu")._adapter
    cache = adapter.init_state(3)
    cfg = pm.cfg
    n = cfg.dec_layers if cfg.family == "encdec" else 1
    assert cache["cross_kv"].shape == (n, 2, 3, cfg.src_len, cfg.kv_heads,
                                       cfg.head_dim_)
    cache["cross_kv"].fill_(1)
    assert adapter.reset_state(cache, np.array([True, True, True])) is cache
    assert bool((cache["cross_kv"] == 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    out = p_serve.main(["--arch", arch, "--smoke", "--quant", "w4a8",
                        "--device", "cpu", "--requests", "2", "--batch",
                        "2", "--max-new", "4"])
    text = capsys.readouterr().out
    name = p_api.get_smoke_config(arch).name
    assert f"{name} [w4a8] params" in text and "tok/s (CPU" in text
    assert [len(r.out) for r in out] == [4, 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_cuts_the_depth(arch, capsys):
    # --layers keeps the widths: vision 5 -> 10 layers (two groups of
    # four self layers and a cross layer), seamless 2 + 2 -> 1 + 1
    layers = 10 if arch == ARCHS[1] else 1
    out = p_serve.main(["--arch", arch, "--smoke", "--quant", "w8a8",
                        "--layers", str(layers), "--device", "cpu",
                        "--requests", "1", "--batch", "1", "--max-new",
                        "2"])
    text = capsys.readouterr().out
    assert f"layers={layers}" in text
    assert [len(r.out) for r in out] == [2]


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = p_api.build(p_api.get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_engine.Engine(model, model.init(0, device="cpu"), 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_serve.main(["--arch", arch, "--smoke"])


def test_forward_needs_the_source_and_fill_needs_cross_layers():
    for arch in ARCHS:
        model = p_api.build(p_api.get_smoke_config(arch))
        params = model.init(0, device="cpu")
        with pytest.raises(ValueError, match="needs src_embed"):
            model.forward(params, {"tokens": torch.zeros((1, 3),
                                                         dtype=torch.long)})
    qwen = p_api.build(p_api.get_smoke_config("qwen2.5-3b"))
    with pytest.raises(ValueError, match="no cross attention"):
        qwen.fill_cross_kv(None, {}, torch.zeros((1, 2, 64)))
