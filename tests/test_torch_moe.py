"""Mixture-of-Experts in the port (`nn/mlp.py::moe_apply`, the MoE branch
of `models/lm.py`, kimi-k2-1t-a32b and llama4-maverick-400b-a17b served
through `Engine` and `repro_torch.launch.serve`) against the reference's,
on the CPU, with the reference's weights carried over as numpy.

kimi-smoke (8 experts, top-2) and llama4-smoke (4 experts, top-1), two
layers each. Compute is float32 unless stated. Tolerances, and why (those
of `tests/test_torch_lm.py`):
- the MoE block: 1e-5 absolute on outputs of order 1 (float32 batched
  matmuls and softmax in another rounding order), the aux loss 1e-6;
- logits: 1e-3 x the largest real logit, the aux loss 1e-5, the loss
  1e-5 relative;
- decode against forward inside the port: 2e-2 absolute, the bound of
  `tests/test_decode_agreement.py`, at ``capacity_factor=8.0`` as there
  (a forward's groups can drop where a decode step's cannot);
- served W4A8 (bf16 compute) logits: 0.1, as `tests/test_torch_lm_serve.py`.
Exact: the routing (experts, position in expert, keep) wherever the k-th
and (k+1)-th probability of a token differ by more than 1e-6 (the block's
inputs are seeded normals, and the test asserts that every real token
has such a margin); every int dense call given the reference's own dense
inputs; the packed trees, uniform and under a ``layers/moe/shared/wi``
plan, float32 and bfloat16.
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
from repro.nn import layers as r_layers
from repro.nn import mlp as r_mlp
from repro.serve import engine as r_engine
from repro_torch.convert import fp_params_from_numpy
from repro_torch.deploy import apply as p_apply
from repro_torch.launch import convert as p_convert
from repro_torch.launch import serve as p_serve
from repro_torch.models import api as p_api
from repro_torch.nn import layers as p_layers
from repro_torch.nn import mlp as p_mlp
from repro_torch.nn import module as p_module
from repro_torch.nn.module import param_bytes, param_count
from repro_torch.serve import engine as p_engine

from test_torch_lm import (BLOCK_ATOL, DECODE_ATOL, LOGIT_RTOL,
                           _assert_trees_identical, _configs, _models, _real,
                           _t, _tokens)
from test_torch_lm_serve import QUANT, TOL, _generate, _prompts
from torch_bridge import assert_same, fp_numpy, jax_tree, np_tree

MODS = ["kimi_k2_1t", "llama4_maverick_400b"]
ARCHS = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]
AUX_ATOL = 1e-6
MODEL_AUX_ATOL = 1e-5
MARGIN = 1e-6
B, S = 2, 8
# the 7 int denses of a MoE layer: the attention and the shared expert
MOE_DENSES = ("layers/attn/wk", "layers/attn/wo", "layers/attn/wq",
              "layers/attn/wv", "layers/moe/shared/wg",
              "layers/moe/shared/wi", "layers/moe/shared/wo")


# -------------------------------------------------------------- block ---

def _block_cfgs(mod, **over):
    rc, pc = _configs(mod)
    m = pc.moe
    kw = dict(d_model=pc.d_model, d_ff=m.d_ff, n_experts=m.n_experts,
              top_k=m.top_k, capacity_factor=m.capacity_factor,
              group_size=m.group_size, act=pc.act)
    kw.update(over)
    return r_mlp.MoeConfig(**kw), p_mlp.MoeConfig(**kw)


def _ref_route(tokens, router, cfg):
    """The reference's routing of token groups (g, gs, d), its own lines
    (`src/repro/nn/mlp.py::moe_apply` keeps them inline): experts,
    position in expert, keep."""
    probs = jax.nn.softmax(jnp.einsum(
        "gtd,de->gte", tokens.astype(jnp.float32),
        router.astype(jnp.float32)), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, cfg.top_k)
    ng, gs = tokens.shape[:2]
    onehot = jax.nn.one_hot(expert_idx, cfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(ng, gs * cfg.top_k, cfg.n_experts)
    pos = ((jnp.cumsum(flat, axis=1) - 1) * flat).sum(-1).reshape(
        ng, gs, cfg.top_k)
    return probs, expert_idx, pos, pos < cfg.capacity(gs)


def _groups(x, gs):
    tokens = x.reshape(-1, x.shape[-1])
    pad = (-tokens.shape[0]) % gs
    tokens = np.pad(tokens, ((0, pad), (0, 0)))
    return tokens.reshape(-1, gs, x.shape[-1]), pad


# (batch, seq, MoeConfig overrides): no drop; capacity drops (64 tokens,
# capacity 5 against 16 choices per expert on average); a padded last
# group (40 tokens in groups of 24)
CASES = {"no_drop": (2, 8, dict(capacity_factor=8.0)),
         "drops": (4, 16, dict(capacity_factor=0.25)),
         "padding": (2, 20, dict(group_size=24))}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mod", MODS)
def test_moe_apply_matches_reference(mod, case):
    b, s, over = CASES[case]
    rc, pc = _block_cfgs(mod, **over)
    fp = fp_numpy(p_mlp.moe_def(pc), seed=21)
    x = np.random.default_rng(22).normal(size=(b, s, pc.d_model)).astype(
        np.float32)
    want_y, want_aux = jax.jit(lambda p, x: r_mlp.moe_apply(p, x, rc))(
        np_tree(fp), jnp.asarray(x))
    got_y, got_aux = p_mlp.moe_apply(_t(fp), torch.from_numpy(x), pc)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=BLOCK_ATOL)
    assert abs(float(got_aux) - float(want_aux)) <= AUX_ATOL

    gs = min(pc.group_size, b * s)
    tokens, pad = _groups(x, gs)
    probs, r_idx, r_pos, r_keep = _ref_route(
        jnp.asarray(tokens), jnp.asarray(fp["router"]), rc)
    p_probs, _, p_idx, p_pos, p_keep = p_mlp.moe_route(
        torch.from_numpy(tokens), torch.from_numpy(fp["router"]), pc)
    real = np.ones(tokens.shape[:2], bool)
    if pad:
        real[-1, -pad:] = False
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    margin = top[..., pc.top_k - 1] - top[..., pc.top_k]
    assert (margin[real] > MARGIN).all(), "a near tie in the seeded router"
    np.testing.assert_allclose(p_probs.numpy(), np.asarray(probs),
                               atol=1e-7)
    for got, want, what in ((p_idx, r_idx, "experts"), (p_pos, r_pos, "pos"),
                            (p_keep, r_keep, "keep")):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), what)
    if case == "drops":
        assert not p_keep.all() and p_keep.any()
    if case == "padding":
        # the all-zero rows tie on every expert and take the lowest, as
        # lax.top_k does; they follow the real tokens in the (t, k) order,
        # so each real choice has the position it has without them
        assert (p_idx[-1, -pad:] == torch.arange(pc.top_k)).all()
        alone = p_mlp.moe_route(torch.from_numpy(tokens[-1:, :-pad]),
                                torch.from_numpy(fp["router"]), pc)[3]
        assert torch.equal(alone[0], p_pos[-1, :-pad])


@pytest.mark.parametrize("mod", MODS)
def test_shared_expert_int_calls_exact_w4a8(mod):
    """The MoE block at W4A8 with bf16 activations: its shared expert's
    three int dense calls, captured from the reference's (jitted)
    moe_apply and replayed through the port's dense_apply, are
    bit-identical; the router and the experts stay float."""
    qr = r_layers.QuantConfig(**QUANT)
    qp = p_layers.QuantConfig(**QUANT)
    rc, pc = _block_cfgs(mod, qcfg=qr)
    pc = dataclasses.replace(pc, qcfg=qp)
    fp = _t(fp_numpy(p_mlp.moe_def(dataclasses.replace(
        pc, qcfg=p_layers.QOFF)), seed=23))
    q = p_apply.apply_plan(p_apply.int_skeleton(p_mlp.moe_def(pc)), fp,
                           None, 4)
    assert q["wi"] is fp["wi"] and q["router"] is fp["router"]
    assert set(q["shared"]["wi"]) == {"w_packed", "w_scale"}
    x = np.random.default_rng(24).normal(size=(B, S, pc.d_model)).astype(
        np.float32)
    calls = []

    def tap(p, x):
        jax.debug.callback(lambda p, x: calls.append((p, x)), p, x)

    with r_layers.dense_tap(tap):
        jax.block_until_ready(jax.jit(lambda p, x: r_mlp.moe_apply(
            p, x, rc))(jax_tree(q), jnp.asarray(x, jnp.bfloat16)))
    jax.effects_barrier()
    assert len(calls) == 3
    r_dense = jax.jit(lambda p, x: r_layers.dense_apply(p, x, qcfg=qr))
    for p, x in calls:
        got = p_layers.dense_apply(_t(p), torch.from_numpy(np.array(
            x.astype(jnp.float32))).to(torch.bfloat16), qcfg=qp)
        assert_same(got, r_dense(p, x), "shared expert dense call")


# -------------------------------------------------------------- models ---

@pytest.mark.parametrize("quant", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("mod", MODS)
def test_forward_and_decode_match_reference(mod, quant):
    (rm, rp), (pm, pp), _ = _models(mod, quant)
    vocab = rm.cfg.vocab
    toks = _tokens(vocab)
    want, want_aux, _ = jax.jit(rm.forward)(rp, {"tokens": jnp.asarray(toks)})
    want = _real(want, vocab)
    got, got_aux, _ = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    tol = LOGIT_RTOL * np.abs(want).max()
    np.testing.assert_allclose(_real(got.numpy(), vocab), want, atol=tol)
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    assert abs(float(got_aux) - float(want_aux)) <= MODEL_AUX_ATOL
    assert float(got_aux) > 0.5        # two layers' Switch losses
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


@pytest.mark.parametrize("mod", MODS)
def test_loss_matches_reference(mod):
    (rm, rp), (pm, pp), _ = _models(mod)
    toks = _tokens(rm.cfg.vocab, seed=5)
    labels = _tokens(rm.cfg.vocab, seed=6)
    want = float(jax.jit(rm.loss)(rp, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)}))
    got = pm.loss(pp, {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # the aux term is in it: with aux_weight 0 the loss moves
    assert float(pm.loss(pp, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)},
                         aux_weight=0.0)) < float(got)


@pytest.mark.parametrize("quant", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("mod", MODS)
def test_decode_reproduces_forward_in_the_port(mod, quant):
    _, (pm, pp), _ = _models(mod, quant, moe={"capacity_factor": 8.0})
    toks = torch.from_numpy(_tokens(pm.cfg.vocab, seed=2, shape=(B, 12)))
    lf, _, _ = pm.forward(pp, {"tokens": toks})
    cache = pm.init_cache(B, 12, torch.float32, device="cpu")
    errs = []
    for t in range(12):
        lg, cache = pm.decode(pp, cache, toks[:, t:t + 1], t)
        errs.append(float((lg[:, 0] - lf[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL, errs


def _tapped_forward_calls(rm, rp):
    calls = []

    def tap(p, x):
        jax.debug.callback(lambda p, x: calls.append((p, x)), p, x)

    with r_layers.dense_tap(tap):
        jax.block_until_ready(jax.jit(rm.forward)(
            rp, {"tokens": jnp.asarray(_tokens(rm.cfg.vocab))}))
    jax.effects_barrier()
    return calls


def _bf16(tree, to):
    return {k: _bf16(v, to) if isinstance(v, dict) else to(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mod", MODS)
def test_int_dense_calls_exact_on_reference_inputs(mod, param_dtype):
    """W4A8, bf16 compute as configured: the packed tree equals the
    reference's (a bfloat16 tree's experts and router pass through as
    bfloat16), and every int dense call of the reference's (jitted)
    forward, 7 per layer, replays bit for bit through the port's
    dense_apply (with a bfloat16 w_scale, as the compiled reference
    rounds it)."""
    (rm, _), (pm, _), fp = _models(mod, 4, param_dtype=param_dtype,
                                   compute_dtype="bfloat16")
    if param_dtype == "bfloat16":
        p_fp = _bf16(_t(fp), lambda t: t.to(torch.bfloat16))
        r_fp = _bf16(np_tree(fp), lambda a: jnp.asarray(a, jnp.bfloat16))
    else:
        p_fp, r_fp = _t(fp), np_tree(fp)
    pp = p_apply.apply_plan(p_apply.int_skeleton(pm.defs()), p_fp, None, 4)
    rp = r_apply.apply_plan(jax.jit(rm.init)(jax.random.PRNGKey(0)), r_fp,
                            None, 4)
    _assert_trees_identical(pp, rp)
    moe = pp["layers"]["moe"]
    assert moe["wi"] is p_fp["layers"]["moe"]["wi"]
    assert moe["wo"].dtype == moe["router"].dtype == getattr(torch,
                                                             param_dtype)
    calls = _tapped_forward_calls(rm, rp)
    assert len(calls) == 7 * rm.cfg.n_layers
    qr = rm.cfg.quant
    qp = p_layers.QuantConfig(mode="int", w_bits=qr.w_bits, a_bits=qr.a_bits)
    r_dense = jax.jit(lambda p, x: r_layers.dense_apply(p, x, qcfg=qr))
    for p, x in calls:
        assert x.dtype == jnp.bfloat16
        got = p_layers.dense_apply(
            {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
                torch.bfloat16) if v.dtype == jnp.bfloat16 else _t(v)
             for k, v in p.items()},
            torch.from_numpy(np.array(x.astype(jnp.float32))).to(
                torch.bfloat16), qcfg=qp)
        assert_same(got, r_dense(p, x), "dense call")


# half of every layers/moe/shared/wi at W8, half at W4 (the shared
# expert's d_ff set to 256); the attention projections at W2
SEG_PLAN = (
    '{"version": 4, "default": {"w_bits": 8, "a_bits": 8}, "rules": ['
    '{"pattern": "layers/moe/shared/wi", "w_bits": 8, "a_bits": 8, '
    '"segments": [[0, 128, 8], [128, 256, 4]]}, '
    '{"pattern": "layers/attn/w*", "w_bits": 2, "a_bits": 8}]}')


@pytest.mark.parametrize("plan", [None, SEG_PLAN],
                         ids=["uniform", "segments"])
@pytest.mark.parametrize("mod", MODS)
def test_packed_trees_identical_and_serve_exact(mod, plan):
    (rm, _), (pm, pp), fp = _models(mod, 4, plan=plan, moe={"d_ff": 256})
    r_fp = np_tree(fp)
    rp = r_apply.apply_plan(jax.jit(rm.init)(jax.random.PRNGKey(0)), r_fp,
                            rm.cfg.quant_plan, 4)
    _assert_trees_identical(pp, rp)
    assert param_bytes(pp) == r_convert.artifact_bytes(rp)
    assert param_count(pp) == sum(a.size for a in jax.tree.leaves(rp))
    paths = p_apply.quantized_dense_paths(pm.defs())
    assert paths == r_apply.quantized_dense_paths(rm.defs()) == MOE_DENSES
    assert p_apply.dense_inventory(_t(fp), paths) == \
        r_apply.dense_inventory(r_fp, paths)
    # the skeleton packs the same tree, its float leaves the fp tree's own
    p_fp = _t(fp)
    sk = p_apply.apply_plan(p_apply.int_skeleton(pm.defs()), p_fp,
                            pm.cfg.quant_plan, 4)
    _assert_trees_identical(sk, rp)
    for name in ("router", "wi", "wg", "wo"):
        assert sk["layers"]["moe"][name] is p_fp["layers"]["moe"][name]
    if plan is None:
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


def test_init_leaf_in_place_gives_the_same_values():
    """`_init_leaf` scales its float32 draw in place: the values are those
    of the out-of-place product, bit for bit, at every init kind."""
    defs = (p_module.ParamDef((3, 40, 24), ("e", "d", "f")),
            p_module.ParamDef((40, 8), ("d", "e"), scale=0.02),
            p_module.ParamDef((40, 24), ("d", "f"), dtype=torch.bfloat16),
            p_module.ParamDef((50, 16), ("v", "d"), "embed", scale=0.5),
            p_module.ParamDef((7,), ("d",)))
    for i, d in enumerate(defs):
        got = p_module._init_leaf(d, 1000 + i, torch.device("cpu"))
        x = torch.randn(d.shape, generator=torch.Generator().manual_seed(
            1000 + i))
        fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.init == "embed" else d.scale / fan ** 0.5
        want = (x * scale).to(d.dtype)
        assert got.dtype == d.dtype and torch.equal(got, want), d


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
    pp = p_convert.convert_params(p_apply.int_skeleton(pm.defs()),
                                  fp_params_from_numpy(fp, "cpu"), 4)
    rm = r_api.build(dataclasses.replace(
        r_api.get_smoke_config(request.param),
        quant=r_layers.QuantConfig(**QUANT)))
    return (rm, jax_tree(pp)), (pm, pp)


def test_engine_tokens_match_reference_engine(served):
    """6 requests on 4 slots; a decode step's group is its 4 rows, whose
    capacity (4) no expert can exceed, so no choice drops and each row is
    served as it would be alone."""
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


@pytest.mark.parametrize("layers", [None, 1], ids=["smoke", "layers1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(arch, layers, capsys):
    cut = [] if layers is None else ["--layers", str(layers)]
    out = p_serve.main(["--arch", arch, "--smoke", "--quant", "w4a8",
                        "--device", "cpu", "--requests", "3", "--batch",
                        "2", "--max-new", "4"] + cut)
    text = capsys.readouterr().out
    name = p_api.get_smoke_config(arch).name
    assert f"{name} [w4a8] params" in text and "tok/s (CPU" in text
    if layers:
        assert f"layers={layers}" in text
    assert [len(r.out) for r in out] == [4, 4, 4]


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = p_api.build(p_api.get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_serve.main(["--arch", arch, "--smoke"])
