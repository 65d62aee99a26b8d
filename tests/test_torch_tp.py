"""Explicit LM tensor parallelism over ``model`` (`repro_torch.parallel.tp`)
against the reference's meshless outputs, on CPU meshes of repeated
``cpu`` positions.

A GSPMD partition never changes what the reference computes, so each
split block of the port (here) and each model, server and train step
(`tests/test_torch_tp_models.py`) runs on (data, model) meshes with
model > 1 and is held against the reference without a mesh, from the
same numpy-seeded weights and inputs.

Tolerances, and why:
- packed calls: exact. A column-parallel N-slice is the whole call's
  columns; a row-parallel K-slice's int32 partials add exactly and one
  dequant follows, so the result is the meshless call's bits;
- float blocks: 1e-5 x max |out| in float32 (partial products, softmax
  statistics and squares summed across positions in another order);
- models: `LOGIT_RTOL` x the largest real logit against the reference
  (the meshless port's own bound), and 1e-5 x it against the port
  without a mesh in float32;
- served tokens: equal to the reference's at every step whose top-1
  margin exceeds `TOL` (the bound of `tests/test_torch_mesh_serve.py`),
  and equal to the port's own meshless tokens throughout;
- training: loss within `LOSS_RTOL`, gradients within `GRAD_TOL` x each
  leaf's max (`tests/test_torch_train.py`).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.nn import attention as r_attn
from repro.nn import layers as r_layers
from repro.nn import mlp as r_mlp
from repro.nn import rglru as r_rglru
from repro.nn import ssm as r_ssm
from repro_torch.core import packing
from repro_torch.models import api as p_api
from repro_torch.models import lm as p_lm
from repro_torch.nn import attention as p_attn
from repro_torch.nn import layers as p_layers
from repro_torch.nn import mlp as p_mlp
from repro_torch.nn import rglru as p_rglru
from repro_torch.nn import ssm as p_ssm
from repro_torch.parallel import mesh as pm
from repro_torch.parallel import tp

from test_torch_lm import _models, _real, _t, _tokens
from torch_bridge import assert_same, fp_numpy, jax_tree, np_tree

MESHES = [(1, 2), (1, 4), (2, 2)]
REL = 1e-5
B = 2



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these blocks are small, so one thread runs
    them faster, and the workers of a parallel run do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _mesh(dp, tp_):
    return pm.make_mesh((dp, tp_), ("data", "model"), "cpu")


def _group(shape):
    """Data block 0 of a (data, model) CPU mesh."""
    return tp.TPGroup(_mesh(*shape), 0)


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * np.abs(want).max())


def _qcfgs(bits):
    if bits is None:
        return r_layers.QOFF, p_layers.QOFF
    kw = dict(mode="int", w_bits=bits, a_bits=8)
    return r_layers.QuantConfig(**kw), p_layers.QuantConfig(**kw)


def _pack(tree, bits):
    """Every dense ``{"w"[, "b"]}`` of a float tree packed at ``bits``."""
    if torch.is_tensor(tree):
        return tree
    if "w" in tree:
        if bits is None:
            return tree
        wp, ws = p_layers.pack_dense_weights(tree["w"], bits)
        return {"w_packed": wp, "w_scale": ws,
                **({"b": tree["b"]} if "b" in tree else {})}
    return {k: _pack(v, bits) for k, v in tree.items()}


# ----------------------------------------------------------- the runs ---

def test_even_runs_keep_whole_chunks():
    runs = tp.even_runs(11008, 4, packing.CHUNK)
    assert [tp.run_len(r) for r in runs] == [2816, 2816, 2688, 2688]
    assert runs[0] == ((0, 2816),) and runs[-1] == ((8320, 11008),)
    # a short last unit, and positions left empty when units run out
    assert tp.even_runs(300, 2, 128) == (((0, 256),), ((256, 300),))
    assert tp.even_runs(128, 4, 128)[1:] == ((), (), ())


@pytest.mark.parametrize("m", [2, 4])
def test_qwen_full_width_layout(m):
    """qwen2.5-3b W4A8: kv-head blocks ('tp') at m=2, q-group runs of
    whole CHUNKs per kv head ('gp') at m=4; wo and the MLP's wo split K
    (row-parallel) at CHUNK boundaries, the MLP at 86 CHUNKs over m."""
    cfg = dataclasses.replace(p_api.get_config("qwen2.5-3b"),
                              quant=_qcfgs(4)[1])
    lay = p_attn.attn_layout(p_lm._attn_cfg(cfg), m)
    assert lay.wo == "row"
    if m == 2:
        assert lay.kind == "tp"
        assert lay.q_runs == (((0, 1024),), ((1024, 2048),))
    else:
        assert lay.kind == "gp"
        assert lay.q_runs[1] == ((256, 512), (1280, 1536))
    runs = p_mlp.mlp_runs(p_lm._mlp_cfg(cfg), m)
    want = [5504, 5504] if m == 2 else [2816, 2816, 2688, 2688]
    assert [tp.run_len(r) for r in runs] == want
    assert p_layers.row_parallel_ok(cfg.quant, runs, 11008)


# -------------------------------------------------------------- dense ---

def _dense(k, n, bits, seed, bias=False):
    rng = np.random.default_rng(seed)
    fp = {"w": torch.from_numpy((rng.normal(size=(k, n)) * 0.2).astype(
        np.float32))}
    if bias:
        fp["b"] = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    return _pack(fp, bits)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_dense_column_and_row_parallel_exact(bits, shape, dtype):
    """A packed dense split over N (dequant on each slice) and over K at
    CHUNK boundaries (raw int32 partials, summed, one dequant), with a
    short last CHUNK, against the reference's meshless `dense_apply`."""
    k, n = 600, 96
    rq, pq = _qcfgs(bits)
    p = _dense(k, n, bits, bits, bias=True)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 4, k)).astype(np.float32)).to(getattr(torch, dtype))
    want = r_layers.dense_apply(jax_tree(p), jnp.asarray(
        x.float().numpy()).astype(getattr(jnp, dtype)), qcfg=rq)
    grp = _group(shape)
    kr = tp.even_runs(k, grp.m, packing.CHUNK)
    got = p_layers.dense_row(p, tp.split(x, kr, -1), qcfg=pq, runs=kr,
                             group=grp, k_full=k)
    assert_same(got, want, "row-parallel")
    nr = tp.even_runs(n, grp.m)
    got = tp.join(p_layers.dense_col(p, x, qcfg=pq, runs=nr, group=grp,
                                     k_full=k), nr, -1, n, "cpu")
    assert_same(got, want, "column-parallel")


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kn", [(11008, 2048), (2048, 2048)],
                         ids=["mlp_wo", "attn_wo"])
def test_row_parallel_exact_at_qwen_shapes(kn, m):
    """qwen2.5-3b's row-parallel projections at W4A8, bf16: 11008 over 4
    is 21.5 CHUNKs, split 22, 22, 21, 21."""
    k, n = kn
    rq, pq = _qcfgs(4)
    p = _dense(k, n, 4, 3)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(4, k)).astype(np.float32)).to(torch.bfloat16)
    grp = _group((1, m))
    kr = tp.even_runs(k, m, packing.CHUNK)
    got = p_layers.dense_row(p, tp.split(x, kr, -1), qcfg=pq, runs=kr,
                             group=grp, k_full=k)
    assert_same(got, r_layers.dense_apply(jax_tree(p), jnp.asarray(
        x.float().numpy()).astype(jnp.bfloat16), qcfg=rq), "row-parallel")


@pytest.mark.parametrize("shape", MESHES)
def test_segmented_container_runs_whole(shape):
    """A segmented (mixed-operand) container never splits: it runs once
    on the leader, its output cut to the runs (column) or its input
    joined (row); both exact."""
    segs = ((0, 128, 8), (128, 192, 4))
    k, n = 256, 192
    kw = dict(mode="int", w_bits=8, a_bits=8, segments=segs)
    rq, pq = r_layers.QuantConfig(**kw), p_layers.QuantConfig(**kw)
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(k, n)).astype(np.float32) * 0.2)
    wf, ws = p_layers.pack_dense_weights_segmented(w, segs)
    p = {"w_packed": wf, "w_scale": ws}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(5, k)).astype(np.float32))
    want = r_layers.dense_apply(jax_tree(p), jnp.asarray(x.numpy()),
                                qcfg=rq)
    grp = _group(shape)
    nr = tp.even_runs(n, grp.m)
    cols = p_layers.dense_col(p, x, qcfg=pq, runs=nr, group=grp, k_full=k)
    assert not p_layers.dense_is_split(p)
    assert_same(tp.join(cols, nr, -1, n, "cpu"), want, "segmented col")
    kr = tp.even_runs(k, grp.m, packing.CHUNK)
    assert_same(p_layers.dense_row(p, tp.split(x, kr, -1), qcfg=pq,
                                   runs=kr, group=grp, k_full=k),
                want, "segmented row")


# ---------------------------------------------------------- attention ---

def _attn_case(strategy, m):
    """(n_heads, kv_heads, prefill length, cache length) that make
    `attn_strategy` pick ``strategy`` on ``m`` model positions."""
    return {"tp": (2 * m, m, 7, 7), "gp": (m, 1, 7, 7),
            "cp": (2 if m == 4 else 3, 1, 8, 8),
            "none": (3, 1, 7, 7)}[strategy]


def _attn(strategy, m, bits):
    h, hk, s, t = _attn_case(strategy, m)
    rq, pq = _qcfgs(bits)
    kw = dict(d_model=48, n_heads=h, kv_heads=hk, head_dim=16,
              qkv_bias=True)
    rc = r_attn.AttnConfig(**kw, qcfg=rq)
    pc = p_attn.AttnConfig(**kw, qcfg=pq)
    fp = fp_numpy(p_attn.attn_def(dataclasses.replace(pc, qcfg=p_layers.QOFF)),
                  seed=h + hk)
    pp = _pack(_t(fp), bits)
    return rc, pc, pp, jax_tree(pp), s, t


STRATEGIES = ["tp", "gp", "cp", "none"]


@pytest.mark.parametrize("bits", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_attention_prefill_and_cross(strategy, shape, bits):
    """`attn_apply` causal, then as cross attention over its own K/V,
    under each strategy: 'tp' kv-head blocks, 'gp' q-group blocks, 'cp'
    q-sequence blocks, 'none' on the leader."""
    grp = _group(shape)
    rc, pc, pp, rp, s, _ = _attn(strategy, grp.m, bits)
    x = np.random.default_rng(5).normal(size=(B, s, 48)).astype(np.float32)
    cos, sin = r_layers.rope_tables(s, 16)
    want, (rk, rv) = r_attn.attn_apply(rp, jnp.asarray(x), rc, cos=cos,
                                       sin=sin, mode="causal")
    pcos, psin = p_layers.rope_tables(s, 16)
    with tp.tp_scope(grp):
        assert p_attn.attn_strategy(pc.kv_heads, pc.groups, s, s) == strategy
        got, (pk, pv) = p_attn.attn_apply(pp, torch.from_numpy(x), pc,
                                          cos=pcos, sin=psin, mode="causal")
        xw, _ = p_attn.attn_apply(pp, torch.from_numpy(x), pc, cos=None,
                                  sin=None, mode="bidir", cross_kv=(pk, pv))
    for a, b in ((got, want), (pk, rk), (pv, rv)):
        _close(a, b)
    want_x, _ = r_attn.attn_apply(rp, jnp.asarray(x), rc, cos=None,
                                  sin=None, mode="bidir", cross_kv=(rk, rv))
    _close(xw, want_x)


@pytest.mark.parametrize("placed", [False, True], ids=["whole", "placed"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_attention_decode(strategy, shape, placed):
    """`attn_decode` over a positional cache, per-slot positions (slot 1
    a step behind), then a cross step over a source cache: the cache
    whole (a split strategy writes and reads views of it) or placed as
    `cache_shardings` places it (kv heads under 'tp', the sequence
    under 'cp')."""
    grp = _group(shape)
    rc, pc, pp, rp, _, t = _attn(strategy, grp.m, None)
    x = np.random.default_rng(6).normal(size=(B, t, 48)).astype(np.float32)
    rcache = r_attn.init_cache(rc, B, t, jnp.float32)
    pcache = p_attn.init_cache(pc, B, t, torch.float32)
    cut = p_attn.kv_cache_cut(pc, pcache["k"].shape, grp.mesh)
    assert (cut is not None) == (strategy in ("tp", "cp"))
    if placed:
        pcache = tp.place(pcache, {"k": cut, "v": cut}, grp)
    with tp.tp_scope(grp):
        assert p_attn.attn_strategy(pc.kv_heads, pc.groups, 1, t) == strategy
        for s in range(t):
            idx = np.array([s, max(s - 1, 0)], np.int32)
            want, rcache = r_attn.attn_decode(
                rp, jnp.asarray(x[:, s:s + 1]), rcache, jnp.asarray(idx),
                rc, mode="causal")
            got, pcache = p_attn.attn_decode(
                pp, torch.from_numpy(x[:, s:s + 1]), pcache,
                torch.from_numpy(idx), pc, mode="causal")
            _close(got, want)
        _close(tp.whole(pcache["k"]), rcache["k"])
        src = (rcache["k"], rcache["v"])
        want, _ = r_attn.attn_decode(rp, jnp.asarray(x[:, :1]), None,
                                     jnp.int32(0), rc, mode="bidir",
                                     cross_kv=src)
        pk, pv = (torch.from_numpy(np.array(a)) for a in src)
        if placed and cut is not None:
            pk, pv = tp.place_leaf(pk, cut, grp), tp.place_leaf(pv, cut, grp)
        got, _ = p_attn.attn_decode(pp, torch.from_numpy(x[:, :1]), None,
                                    0, pc, mode="bidir", cross_kv=(pk, pv))
    _close(got, want)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("shape", MESHES)
def test_ring_decode_past_a_wrap_under_cp(shape, vector):
    """The local-attention ring of 8 slots under 'cp': each position
    holds 8/m slots, the true-position mask is computed per block, and
    a block whose slots are all masked (the first steps) weighs 0."""
    grp = _group(shape)
    rc, pc, pp, rp, _, t = _attn("cp", grp.m, None)
    n = 13
    x = np.random.default_rng(7).normal(size=(B, n, 48)).astype(np.float32)
    rcache = r_attn.init_cache(rc, B, t, jnp.float32)
    whole = p_attn.init_cache(pc, B, t, torch.float32)
    cut = p_attn.kv_cache_cut(pc, whole["k"].shape, grp.mesh)
    assert cut.dim == -3
    pcache = tp.place(whole, {"k": cut, "v": cut}, grp)
    with tp.tp_scope(grp):
        for s in range(n):
            idx = np.array([s, max(s - 2, 0)], np.int32) if vector else s
            want, rcache = r_attn.attn_decode(
                rp, jnp.asarray(x[:, s:s + 1]), rcache,
                jnp.asarray(idx, jnp.int32), rc, mode="local", window=6,
                ring=True)
            got, pcache = p_attn.attn_decode(
                pp, torch.from_numpy(x[:, s:s + 1]), pcache,
                torch.from_numpy(idx) if vector else idx, pc, mode="local",
                window=6, ring=True)
            _close(got, want)


# ---------------------------------------------------------- MLP, MoE ---

@pytest.mark.parametrize("bits", [None, 8, 4], ids=["fp", "w8a8", "w4a8"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act, shape, bits):
    """wi / wg column-parallel, wo row-parallel over d_ff 384 (3 CHUNKs:
    uneven over 2 and 4 positions when packed): against the reference;
    packed, bit for bit the port's meshless block."""
    rq, pq = _qcfgs(bits)
    rc, pc = r_mlp.MlpConfig(48, 384, act, rq), p_mlp.MlpConfig(48, 384,
                                                               act, pq)
    fp = fp_numpy(p_mlp.mlp_def(p_mlp.MlpConfig(48, 384, act)), seed=11)
    pp = _pack(_t(fp), bits)
    x = np.random.default_rng(12).normal(size=(B, 5, 48)).astype(np.float32)
    want = r_mlp.mlp_apply(jax_tree(pp), jnp.asarray(x), rc)
    alone = p_mlp.mlp_apply(pp, torch.from_numpy(x), pc)
    with tp.tp_scope(_group(shape)):
        got = p_mlp.mlp_apply(pp, torch.from_numpy(x), pc)
    _close(got, want, REL if bits is None else 1e-2)
    if bits is not None:
        assert_same(got, alone, "int MLP")


@pytest.mark.parametrize("drops", [False, True], ids=["no_drop", "drops"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("mod", ["kimi_k2_1t", "llama4_maverick_400b"])
def test_moe_expert_parallel(mod, shape, drops):
    """E / m experts per position on their slots, routing and capacity
    replicated: the same tokens kept as without a mesh."""
    from test_torch_moe import _block_cfgs
    rc, pc = _block_cfgs(mod, capacity_factor=0.25 if drops else 8.0)
    fp = fp_numpy(p_mlp.moe_def(pc), seed=21)
    b, s = (4, 16) if drops else (2, 8)
    x = np.random.default_rng(22).normal(size=(b, s, pc.d_model)).astype(
        np.float32)
    want_y, want_aux = r_mlp.moe_apply(np_tree(fp), jnp.asarray(x), rc)
    grp = _group(shape)
    with tp.tp_scope(grp):
        got_y, got_aux = p_mlp.moe_apply(_t(fp), torch.from_numpy(x), pc)
    assert isinstance(tp.place(_t(fp), p_mlp.moe_cuts(pc, grp.m),
                               grp)["wi"], tp.Split)
    _close(got_y, want_y)
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6


# --------------------------------------------------------- SSM, RG-LRU ---

@pytest.mark.parametrize("bits", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("shape", MESHES)
def test_mamba_block(shape, bits):
    """Head blocks with B / C replicated, the gated RMSNorm's squares
    summed across positions; the decode state split over heads and
    channels."""
    rq, pq = _qcfgs(bits)
    kw = dict(d_model=32, d_state=8, headdim=8, chunk=8)
    rc = r_ssm.MambaConfig(**kw, qcfg=rq)
    pc = p_ssm.MambaConfig(**kw, qcfg=pq)
    pp = _pack(_t(fp_numpy(p_ssm.mamba_def(p_ssm.MambaConfig(**kw)), 5)),
               bits)
    rp = jax_tree(pp)
    n = 13
    x = (np.random.default_rng(13).normal(size=(B, n, 32))).astype(
        np.float32)
    grp = _group(shape)
    with tp.tp_scope(grp):
        got = p_ssm.mamba_apply(pp, torch.from_numpy(x), pc)
    _close(got, r_ssm.mamba_apply(rp, jnp.asarray(x), rc),
           REL if bits is None else 1e-2)
    if bits is not None:
        _close(got, p_ssm.mamba_apply(pp, torch.from_numpy(x), pc))
    rcache = r_ssm.mamba_init_cache(rc, B, jnp.float32)
    pcache = tp.place(p_ssm.mamba_init_cache(pc, B, torch.float32),
                      p_ssm.mamba_cache_cuts(pc, grp.m), grp)
    with tp.tp_scope(grp):
        for t in range(n):
            want, rcache = r_ssm.mamba_decode(rp, jnp.asarray(x[:, t:t + 1]),
                                              rcache, rc)
            got, pcache = p_ssm.mamba_decode(
                pp, torch.from_numpy(x[:, t:t + 1]), pcache, pc)
            _close(got, want, REL if bits is None else 1e-2)
    if bits is None:
        _close(tp.whole(pcache["ssm"]), rcache["ssm"])
        _close(tp.whole(pcache["conv"]), rcache["conv"])


@pytest.mark.parametrize("bits", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("shape", MESHES)
def test_rglru_block(shape, bits):
    """LRU-width runs per position (whole CHUNKs when packed); w_a / w_i
    and out row-parallel, the recurrence local."""
    rq, pq = _qcfgs(bits)
    rc, pc = r_rglru.RglruConfig(32, 256, qcfg=rq), p_rglru.RglruConfig(
        32, 256, qcfg=pq)
    pp = _pack(_t(fp_numpy(p_rglru.rglru_block_def(
        p_rglru.RglruConfig(32, 256)), 3)), bits)
    rp = jax_tree(pp)
    n = 11
    x = np.random.default_rng(3).normal(size=(B, n, 32)).astype(np.float32)
    grp = _group(shape)
    with tp.tp_scope(grp):
        got = p_rglru.rglru_block_apply(pp, torch.from_numpy(x), pc)
    tol = REL if bits is None else 1e-2
    _close(got, r_rglru.rglru_block_apply(rp, jnp.asarray(x), rc), tol)
    rcache = r_rglru.rglru_init_cache(rc, B, jnp.float32)
    pcache = tp.place(p_rglru.rglru_init_cache(pc, B, torch.float32),
                      p_rglru.rglru_cache_cuts(pc, grp.m), grp)
    with tp.tp_scope(grp):
        for t in range(n):
            want, rcache = r_rglru.rglru_block_decode(
                rp, jnp.asarray(x[:, t:t + 1]), rcache, rc)
            got, pcache = p_rglru.rglru_block_decode(
                pp, torch.from_numpy(x[:, t:t + 1]), pcache, pc)
            _close(got, want, tol)
    _close(tp.whole(pcache["h"]), rcache["h"], tol)


# -------------------------------------------------------------- heads ---

@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_vocab_parallel_embedding_and_head(tied, shape):
    """The table's rows (or the head's columns) per position: a lookup
    adds exact zeros, the logits gather on the leader, padded rows
    masked."""
    mod = "olmo_1b" if tied else "llama3p2_vision_90b"
    (rm, rp), (pm_, pp), _ = _models(mod)
    cfg = pm_.cfg
    assert cfg.tie_embeddings == tied
    toks = _tokens(cfg.vocab)
    x = np.random.default_rng(4).normal(size=(B, 8, cfg.d_model)).astype(
        np.float32)
    from repro.models import lm as r_lm
    want = r_lm._logits(rp, jnp.asarray(x), rm.cfg)
    want_e = np.asarray(rp["embed"]["table"])[toks]
    with tp.tp_scope(_group(shape)):
        got = p_lm._logits(pp, torch.from_numpy(x), cfg)
        got_e = p_layers.embedding_apply(pp["embed"], torch.from_numpy(toks))
    _close(_real(got.numpy(), cfg.vocab), _real(want, cfg.vocab))
    assert np.all(got.numpy()[..., cfg.vocab:] == -1e9)
    assert_same(got_e, want_e, "vocab-parallel lookup")
