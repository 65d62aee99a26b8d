"""Kimi-K2-Instruct on the port (`nn/mla.py`, the dropless MoE of
`nn/mlp.py`, the dense-then-MoE schedule and latent cache of
`models/lm.py`, `configs/kimi_k2_instruct.py`) against the plain reference
`tests/plain_ref/mla_moe_lm.py`, on the CPU at kimi-instruct-smoke's
size (3 layers: 1 dense, 2 MoE; 16 routed experts, top-4; the published
YaRN and routing settings).

Tolerances, and why:
- float32 compute: 1e-5 x the largest |value| (the port's einsum scores
  and batched GEMMs against the reference's per-row matmuls: another
  rounding order, nothing else);
- W4A8, bfloat16 compute: 3e-2 x the largest |logit|. Both sides take
  the same integer products and agree bit for bit here; the room is for
  a bfloat16 value one rounding apart (another BLAS, another order),
  which lands one activation code apart and three random-weight layers
  carry on; the A4 control is ten times further off (asserted too);
- the router's choices are exact: both sides score the same float32
  inputs with the same operations.
"""
import ast
import dataclasses
import importlib.util
import json
import math
import pathlib

import pytest
import torch

from repro_torch.configs import kimi_k2_instruct as kimi
from repro_torch.deploy.apply import int_skeleton
from repro_torch.launch.convert import convert_params
from repro_torch.models import api, lm
from repro_torch.nn import layers as p_layers
from repro_torch.nn import mlp as p_mlp
from repro_torch.nn.layers import QuantConfig
from repro_torch.obs import trace as obs

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_PATH = ROOT / "tests" / "plain_ref" / "mla_moe_lm.py"
BENCH_REF = ROOT / "portbench" / "reference" / "mla_moe_lm.py"
BENCH_CFG = ROOT / "portbench" / "configs" / "kimi-k2-instruct-w4a8-ep8.json"
F32_RTOL = 1e-5
W4A8_RTOL = 3e-2
B, S = 2, 12


def _load_ref():
    spec = importlib.util.spec_from_file_location("plain_mla_moe_lm",
                                                  REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_ref()


def _cfg(kind: str, **moe):
    base = kimi.smoke_config()
    if moe:
        base = dataclasses.replace(base,
                                   moe=dataclasses.replace(base.moe, **moe))
    if kind == "float32":
        return dataclasses.replace(base, compute_dtype="float32")
    return dataclasses.replace(base, quant=QuantConfig(
        mode="int", w_bits=4, a_bits=int(kind[-1]), a_absmax=4.0))


def ref_cfg(cfg) -> dict:
    """The reference's configuration (published key names) of a port
    config."""
    ys = cfg.rope_scaling
    m = cfg.moe
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "q_lora_rank": cfg.q_lora_rank, "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": {"type": "yarn", "factor": ys.factor,
                         "original_max_position_embeddings":
                             ys.original_max_position,
                         "beta_fast": ys.beta_fast,
                         "beta_slow": ys.beta_slow, "mscale": ys.mscale,
                         "mscale_all_dim": ys.mscale_all_dim},
        "num_hidden_layers": cfg.n_layers,
        "first_k_dense_replace": cfg.first_dense_layers,
        "num_experts_per_tok": m.top_k, "scoring_func": "sigmoid",
        "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
        "norm_topk_prob": m.norm_topk,
        "routed_scaling_factor": m.routed_scale,
        "n_shared_experts": int(m.shared_expert),
        "experts_offset": m.experts_offset, "rms_norm_eps": 1e-6,
        "vocab_size": cfg.vocab, "w_bits": cfg.quant.w_bits,
        "a_absmax": cfg.quant.a_absmax, "compute_dtype": cfg.compute_dtype}


def _fp(cfg, seed=0):
    """Float weights of ``cfg`` (its float build), the router bias drawn
    N(0, 1e-3) so the selection-only bias moves choices."""
    fcfg = dataclasses.replace(cfg, quant=p_layers.QOFF)
    fp = api.build(fcfg).init(seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    rb = fp["layers"]["moe"]["router_bias"]
    rb.copy_(1e-3 * torch.randn(rb.shape, generator=gen))
    return fp


def _params(cfg, fp):
    if cfg.quant.mode != "int":
        return fp
    return convert_params(int_skeleton(api.build(cfg).defs()), fp,
                          cfg.quant.w_bits)


def _layer_weights(cfg, fp):
    """Layer i of the fp tree (dense layers first), unstacked."""
    def get(i):
        if i < cfg.first_dense_layers:
            return lm.layer_params(fp["dense_layers"], i)
        return lm.layer_params(fp["layers"], i - cfg.first_dense_layers)
    return get


def _top(fp):
    return {k: fp[k] for k in ("embed", "final_norm", "head")}


def _tokens(seed=0, b=B, s=S, vocab=128):
    return torch.randint(0, vocab, (b, s),
                         generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _tol(kind):
    return F32_RTOL if kind == "float32" else W4A8_RTOL


def _a_bits(cfg):
    return None if cfg.quant.mode != "int" else cfg.quant.a_bits


# --------------------------------------------------------- rope, MLA ---

def test_yarn_frequencies_at_the_published_values():
    """Pairs 0-19 keep theta^(-2i/64), 20-31 are divided by 32 (low 19,
    high 20 of 32 pairs), cos / sin unscaled, and the reference gives the
    same frequencies; the score scale is 192^-0.5 x (0.1 ln 32 + 1)^2."""
    cfg = kimi.CONFIG
    ys = cfg.rope_scaling
    assert p_layers.yarn_correction_range(ys, 64, cfg.rope_theta) == (19, 20)
    assert ys.attention_factor() == 1.0
    f = p_layers._freqs(cfg.rope_theta, 32, torch.device("cpu"), ys)
    base = p_layers._freqs(cfg.rope_theta, 32, torch.device("cpu"))
    torch.testing.assert_close(f[:20], base[:20], rtol=0, atol=0)
    torch.testing.assert_close(f[20:], base[20:] / 32, rtol=1e-6, atol=0)
    want = ref.inv_freq(ref_cfg(dataclasses.replace(
        cfg, quant=QuantConfig(mode="int"))), "cpu")
    torch.testing.assert_close(f, want, rtol=2e-7, atol=0)
    mcfg = lm._mla_cfg(cfg)
    m = 0.1 * math.log(32) + 1
    assert mcfg.softmax_scale == pytest.approx(192 ** -0.5 * m * m,
                                               rel=1e-12)
    assert m == pytest.approx(1.3466, abs=1e-4)


@pytest.mark.parametrize("kind", ["float32", "w4a8"])
def test_mla_dense_layer_against_the_reference(kind):
    """The leading dense layer (latent attention with YaRN, then the
    dense SwiGLU) on a random residual, the port's `_block` against the
    reference's `layer`, with the latent both keep."""
    cfg = _cfg(kind)
    fp = _fp(cfg)
    params = _params(cfg, fp)
    dt = lm._compute_dtype(cfg)
    x = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).to(dt)
    cos, sin = lm._ropes(cfg, S, dt, "cpu")[0]
    got, _, (c_kv, k_pe) = lm._block(
        cfg, lm.layer_params(params["dense_layers"], 0), x, cos, sin, None,
        "dense_layers")
    rc = ref_cfg(cfg)
    seen = []
    want = ref.layer(rc, lm.layer_params(fp["dense_layers"], 0), x,
                     *ref.rope_tables(rc, S, dt, "cpu"),
                     None if kind == "float32" else (4, 8, 4.0),
                     lambda c, p: seen.append((c, p)))
    (c_want, p_want), = seen
    assert _rel(got, want) < _tol(kind)
    assert _rel(c_kv, c_want) < _tol(kind)
    assert _rel(k_pe, p_want) < _tol(kind)


# --------------------------------------------------------- the router ---

def test_sigmoid_noaux_router_choices_equal_the_reference():
    cfg = _cfg("float32")
    mcfg = lm._moe_cfg(cfg)
    fp = _fp(cfg)
    moe = lm.layer_params(fp["layers"], 0)["moe"]
    h = torch.randn(64, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    w, idx = p_mlp.moe_select(h, moe, mcfg)
    w_ref, idx_ref = ref.route(ref_cfg(cfg), h, moe["router"],
                               moe["router_bias"])
    assert torch.equal(idx, idx_ref)
    torch.testing.assert_close(w, w_ref, rtol=1e-6, atol=1e-6)
    # renormalised to 1, times the scaling factor
    torch.testing.assert_close(w.sum(-1), torch.full((64,), 2.827),
                               rtol=1e-5, atol=0)
    # the bias selects: a large bias on one expert makes every token
    # choose it, with its own sigmoid as the weight
    biased = dict(moe, router_bias=moe["router_bias"].clone())
    biased["router_bias"][7] = 10.0
    _, idx_b = p_mlp.moe_select(h, biased, mcfg)
    assert bool((idx_b == 7).any(-1).all())


def test_ep_shares_add_up_to_the_uncut_layer():
    """Eight expert-parallel ranks of 2 of the 16 experts each: their
    partial routed outputs, with the shared expert counted once, add up
    to the reference's uncut MoE layer; every choice lands on one rank."""
    cfg = _cfg("float32")
    fp = _fp(cfg)
    moe = lm.layer_params(fp["layers"], 0)["moe"]
    h = torch.randn(B, S, cfg.d_model,
                    generator=torch.Generator().manual_seed(7))
    want = ref.moe(ref_cfg(cfg), h, moe, None)
    shared = p_mlp.mlp_apply(moe["shared"], h, lm._moe_cfg(cfg).shared())
    total = shared.clone()
    rows = 0
    for r in range(8):
        part = dataclasses.replace(lm._moe_cfg(cfg), experts_held=2,
                                   experts_offset=2 * r,
                                   shared_expert=False)
        mp = {k: v for k, v in moe.items() if k != "shared"}
        for name in ("wi", "wg", "wo"):
            mp[name] = {"w": moe[name]["w"][2 * r:2 * r + 2]}
        with obs.enabled_scope():
            obs.reset()
            total = total + p_mlp.moe_held_apply(mp, h, part)
            rows += obs.counter_values()["moe.held_rows"]
    assert rows == B * S * cfg.moe.top_k
    assert _rel(total, want) < F32_RTOL


# ------------------------------------------------------- whole model ---

@pytest.mark.parametrize("kind", ["float32", "w4a8"])
def test_model_prefill_against_the_reference(kind):
    """`Model.prefill` (last-position logits, every layer's latent) of
    the registered family at smoke size, against the reference; the A4
    control lands far outside the W4A8 tolerance."""
    cfg = _cfg(kind)
    fp = _fp(cfg)
    model = api.build(cfg)
    toks = _tokens()
    logits, (c_kv, k_pe) = model.prefill(_params(cfg, fp), {"tokens": toks})
    assert c_kv.shape == (cfg.n_layers, B, S, cfg.kv_lora_rank)
    assert k_pe.shape == (cfg.n_layers, B, S, cfg.qk_rope_dim)
    seen = {}
    (want,) = ref.logits(ref_cfg(cfg), _top(fp), _layer_weights(cfg, fp),
                         [toks], _a_bits(cfg),
                         on_latent=lambda i, slot, c, p:
                         seen.__setitem__(i, (c, p)))
    got = logits[:, 0, :cfg.vocab]
    assert _rel(got, want) < _tol(kind)
    for i in range(cfg.n_layers):
        assert _rel(c_kv[i], seen[i][0]) < _tol(kind)
        assert _rel(k_pe[i], seen[i][1]) < _tol(kind)
    if kind == "w4a8":
        (low,) = ref.logits(ref_cfg(cfg), _top(fp), _layer_weights(cfg, fp),
                            [toks], 4)
        assert _rel(low, want) > 10 * W4A8_RTOL


@pytest.mark.parametrize("kind", ["float32", "w4a8"])
def test_prefill_then_decode_through_the_latent_cache(kind):
    """8 prompt tokens through `Model.prefill`, the latent into a cache
    (`cache_from_prefill`), then 4 `Model.decode` steps: every step's
    logits against the reference's full forward over all 12 tokens."""
    cfg = _cfg(kind)
    fp = _fp(cfg)
    params = _params(cfg, fp)
    model = api.build(cfg)
    toks = _tokens(seed=1)
    p = 8
    _, kvs = model.prefill(params, {"tokens": toks[:, :p]})
    cache = lm.cache_from_prefill(cfg, kvs, S, dtype=kvs[0].dtype)
    assert cache["latent"]["c_kv"].shape == (cfg.n_layers, B, S,
                                             cfg.kv_lora_rank)
    (want,) = ref.logits(ref_cfg(cfg), _top(fp), _layer_weights(cfg, fp),
                         [toks], _a_bits(cfg), last_only=False)
    for t in range(p, S):
        out, cache = model.decode(params, cache, toks[:, t:t + 1], t)
        assert _rel(out[:, 0, :cfg.vocab], want[:, t]) < _tol(kind), t
    # a per-slot index vector decodes the same as the scalar
    cache = lm.cache_from_prefill(cfg, kvs, S, dtype=kvs[0].dtype)
    a, _ = model.decode(params, cache, toks[:, p:p + 1],
                        torch.full((B,), p))
    cache = lm.cache_from_prefill(cfg, kvs, S, dtype=kvs[0].dtype)
    b, _ = model.decode(params, cache, toks[:, p:p + 1], p)
    assert torch.equal(a, b)


def test_moe_spans_and_counters():
    """A prefill opens the latent-attention and MoE spans; the counters
    count every held choice once and the busiest expert's rows."""
    cfg = _cfg("w4a8")
    params = _params(cfg, _fp(cfg))
    with obs.enabled_scope():
        obs.reset()
        api.build(cfg).prefill(params, {"tokens": _tokens()})
        names = {e["name"] for e in obs.events()}
        counts = obs.counter_values()
    assert {"lm/embed", "lm/attn.qkv", "lm/attn.core", "lm/attn.out",
            "lm/mlp", "lm/moe.route", "lm/moe.experts", "lm/moe.shared",
            "lm/head"} <= names
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert counts["moe.held_rows"] == n_moe * B * S * cfg.moe.top_k
    assert 0 < counts["moe.rows_max_expert"] <= counts["moe.held_rows"]


def test_packed_experts_pack_per_expert_along_their_own_k():
    cfg = _cfg("w4a8")
    fp = _fp(cfg)
    params = _params(cfg, fp)
    wi = params["layers"]["moe"]["wi"]
    n_moe, e = cfg.n_layers - 1, cfg.moe.n_experts
    assert wi["w_packed"].dtype == torch.int8
    assert wi["w_packed"].shape == (n_moe, e, 128 // 2, cfg.moe.d_ff)
    assert wi["w_scale"].shape == (n_moe, e, cfg.moe.d_ff)
    w = fp["layers"]["moe"]["wi"]["w"][1, 3]
    packed, scale = p_layers.pack_dense_weights(w, 4)
    assert torch.equal(wi["w_packed"][1, 3], packed)
    assert torch.equal(wi["w_scale"][1, 3], scale)
    # the router and its bias stay float32
    assert params["layers"]["moe"]["router"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        lm.lm_cuts(cfg, 2)


def test_grouped_expert_gemms_equal_dense_apply_per_expert():
    """The packed experts' grouped launches give `dense_apply`'s result
    on each expert's rows bit for bit, an expert with no rows too."""
    cfg = _cfg("w4a8")
    mcfg = lm._moe_cfg(cfg)
    moe = lm.layer_params(_params(cfg, _fp(cfg))["layers"], 0)["moe"]
    counts = [3, 0, 5, 1] + [0] * (cfg.moe.experts_held - 4)
    xs = torch.randn(sum(counts), cfg.d_model,
                     generator=torch.Generator().manual_seed(9)).to(
        torch.bfloat16)
    got = p_mlp._held_experts(moe, xs, counts, mcfg)
    start = 0
    for e, c in enumerate(counts):
        one = {n: {k: v[e] for k, v in moe[n].items()}
               for n in ("wi", "wg", "wo")}
        x = xs[start:start + c]
        q = mcfg.q("wi")
        h = p_layers.dense_apply(one["wi"], x, qcfg=q)
        g = p_layers.dense_apply(one["wg"], x, qcfg=q)
        want = p_layers.dense_apply(one["wo"], p_mlp._act(h, g, "swiglu"),
                                    qcfg=q)
        assert torch.equal(got[start:start + c], want), e
        start += c


# ------------------------------------------- configuration, reference ---

PUBLISHED = {
    "num_hidden_layers": 61, "hidden_size": 7168,
    "num_attention_heads": 64, "q_lora_rank": 1536, "kv_lora_rank": 512,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
    "intermediate_size": 18432, "moe_intermediate_size": 2048,
    "first_k_dense_replace": 1, "n_routed_experts": 384,
    "num_experts_per_tok": 8, "n_shared_experts": 1,
    "routed_scaling_factor": 2.827, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "topk_method": "noaux_tc", "n_group": 1,
    "topk_group": 1, "rope_theta": 50000, "vocab_size": 163840,
    "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "rope_scaling": {"beta_fast": 1, "beta_slow": 1, "factor": 32,
                     "mscale": 1, "mscale_all_dim": 1,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"}}


def _port_view(cfg) -> dict:
    m, ys = cfg.moe, cfg.rope_scaling
    return {
        "num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
        "num_attention_heads": cfg.n_heads, "q_lora_rank": cfg.q_lora_rank,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim,
        "intermediate_size": cfg.dense_d_ff,
        "moe_intermediate_size": m.d_ff,
        "first_k_dense_replace": cfg.first_dense_layers,
        "n_routed_experts": m.n_experts, "num_experts_per_tok": m.top_k,
        "n_shared_experts": int(m.shared_expert),
        "routed_scaling_factor": m.routed_scale,
        "norm_topk_prob": m.norm_topk,
        "scoring_func": {"sigmoid_noaux": "sigmoid"}[m.scoring],
        "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
        "rope_theta": cfg.rope_theta, "vocab_size": cfg.vocab,
        "rms_norm_eps": 1e-6, "tie_word_embeddings": cfg.tie_embeddings,
        "rope_scaling": {"beta_fast": ys.beta_fast,
                         "beta_slow": ys.beta_slow, "factor": ys.factor,
                         "mscale": ys.mscale,
                         "mscale_all_dim": ys.mscale_all_dim,
                         "original_max_position_embeddings":
                             ys.original_max_position, "type": "yarn"}}


def test_registered_config_is_the_published_one_and_the_benchmarks():
    cfg = api.get_config("kimi-k2-instruct")
    assert cfg.moe.experts_held == 384
    assert cfg.moe.experts_offset == 0 and cfg.d_ff == cfg.moe.d_ff
    assert _port_view(cfg) == PUBLISHED
    bench = json.loads(BENCH_CFG.read_text())
    for key, want in PUBLISHED.items():
        if key in bench["published"]:
            assert bench["published"][key] == want, key
        else:
            assert bench[key] == want, key
    assert set(bench["published"]) == {"num_hidden_layers",
                                       "n_routed_experts"}
    assert bench["num_hidden_layers"] == 8 and bench["n_routed_experts"] == 48
    assert "kimi-k2-instruct" in api.list_archs()


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add((node.module or "").split(".")[0])
    return out


def test_reference_copies_are_identical_and_plain():
    assert REF_PATH.read_bytes() == BENCH_REF.read_bytes()
    assert _imports(REF_PATH) == {"__future__", "torch"}
