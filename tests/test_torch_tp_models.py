"""Explicit LM tensor parallelism over ``model``: whole models, serving
and training (`tests/test_torch_tp.py` holds the split blocks), against
the reference's meshless outputs on CPU meshes of repeated ``cpu``
positions. Tolerances as stated there.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models import api as r_api
from repro.nn import layers as r_layers
from repro.serve import engine as r_engine
from repro_torch import convert
from repro_torch.ckpt import checkpoint as p_ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import convert as p_convert
from repro_torch.launch import serve as p_serve
from repro_torch.models import api as p_api
from repro_torch.nn import layers as p_layers
from repro_torch.parallel import mesh as pm
from repro_torch.parallel import tp
from repro_torch.serve import engine as p_engine
from repro_torch.serve.runtime import adapters as p_adapters
from repro_torch.serve.runtime import scheduler as p_sched
from repro_torch.train import optimizer as p_opt
from repro_torch.train.step import (TrainStepConfig, loss_and_grads,
                                    make_decode_fns, make_prefill_fns,
                                    make_train_fns)

from test_torch_encdec import _ref_cross_kv
from test_torch_lm import LOGIT_RTOL, _models, _real, _tokens
from torch_bridge import fp_numpy, jax_tree, np_tree

MESHES = [(1, 2), (1, 4), (2, 2)]
REL = 1e-5
TOL = 0.1
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
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


# ------------------------------------------------------------- models ---

FAMILIES = ["qwen2p5_3b", "olmo_1b", "kimi_k2_1t", "llama4_maverick_400b",
            "seamless_m4t_large_v2", "llama3p2_vision_90b",
            "recurrentgemma_9b", "mamba2_370m"]
S = 8


def _src(cfg):
    if cfg.family != "encdec" and not cfg.cross_every:
        return None
    return (np.random.default_rng(9).normal(
        size=(B, cfg.src_len, cfg.d_model)) * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(mod, bits):
    """The models and params of `test_torch_lm._models`, with the
    reference's meshless forward logits and decode logits per step."""
    (rm, rp), (pm_, pp), _ = _models(mod, bits)
    cfg = rm.cfg
    toks = _tokens(cfg.vocab)
    src = _src(cfg)
    batch = {"tokens": jnp.asarray(toks)}
    if src is not None:
        batch["src_embed"] = jnp.asarray(src)
    fwd = _real(jax.jit(rm.forward)(rp, batch)[0], cfg.vocab)
    rcache = rm.init_cache(B, 16, jnp.float32)
    if src is not None:
        rcache["cross_kv"] = _ref_cross_kv(rm, rp, src)
    dec = jax.jit(rm.decode)
    steps = []
    for t in range(S):
        lg, rcache = dec(rp, rcache, jnp.asarray(toks[:, t:t + 1]),
                         jnp.int32(t))
        steps.append(_real(lg, cfg.vocab))
    return pm_, pp, toks, src, fwd, steps


@pytest.mark.parametrize("bits,shape", [(None, (1, 2)), (4, (1, 2)),
                                        (None, (1, 4))],
                         ids=["fp-1x2", "w4a8-1x2", "fp-1x4"])
@pytest.mark.parametrize("mod", FAMILIES)
def test_model_forward_and_decode(mod, bits, shape):
    """`Model.forward` under the active mesh (`use_mesh`: data block 0),
    then decode over a cache placed on the group with the params placed
    once (as the server does), against the reference's meshless
    logits."""
    from repro_torch.parallel.ctx import use_mesh

    pm_, pp, toks, src, fwd, steps = _reference(mod, bits)
    cfg = pm_.cfg
    tol = LOGIT_RTOL * np.abs(fwd).max()
    batch = {"tokens": torch.from_numpy(toks)}
    if src is not None:
        batch["src_embed"] = torch.from_numpy(src)
    mesh = _mesh(*shape)
    with use_mesh(mesh):
        got = _real(pm_.forward(pp, batch)[0].numpy(), cfg.vocab)
    np.testing.assert_allclose(got, fwd, atol=tol)
    alone = _real(pm_.forward(pp, batch)[0].numpy(), cfg.vocab)
    if bits is None:
        _close(got, alone)
    grp = tp.TPGroup(mesh, 0)
    placed = pm_.place(pp, grp)
    cache = pm_.place_cache(pm_.init_cache(B, 16, torch.float32,
                                           device="cpu"), grp)
    with tp.tp_scope(grp):
        if src is not None:
            pm_.fill_cross_kv(placed, cache, torch.from_numpy(src))
        for t in range(S):
            lg, cache = pm_.decode(placed, cache, torch.from_numpy(
                toks[:, t:t + 1]), torch.full((B,), t))
            np.testing.assert_allclose(_real(lg.numpy(), cfg.vocab),
                                       steps[t], atol=tol)


def test_placed_params_are_split_weight_stationary():
    """Serving places each leaf once: split leaves hold their slices
    (bytes summing to the whole, the MoE experts as views), the norms
    replicated."""
    pm_, pp, *_ = _reference("kimi_k2_1t", 4)
    grp = _group((1, 2))
    placed = pm_.place(pp, grp)
    wq = placed["layers"]["attn"]["wq"]["w_packed"]
    assert isinstance(wq, tp.Split) and wq.dim == -1
    assert sum(t.nbytes for t in wq.parts) == \
        pp["layers"]["attn"]["wq"]["w_packed"].nbytes
    assert isinstance(placed["layers"]["moe"]["wi"], tp.Split)
    assert placed["layers"]["moe"]["router"] is pp["layers"]["moe"]["router"]
    assert torch.is_tensor(placed["final_norm"]["scale"])


# ------------------------------------------------------------ serving ---

MAX_NEW = 6
SERVED = ["qwen2.5-3b", "kimi-k2-1t-a32b", "seamless-m4t-large-v2",
          "recurrentgemma-9b", "mamba2-370m"]


@functools.lru_cache(maxsize=None)
def _served(arch):
    """W4A8 smoke models of both packages from the same numpy weights
    (the embedding scaled by 0.1, `tests/test_torch_lm_serve.py`), and
    the reference's meshless `Engine` tokens and logit rows."""
    from test_torch_mesh_serve import _prompts, _run
    quant = dict(mode="int", w_bits=4, a_bits=8)
    base = p_api.get_smoke_config(arch)
    fp = fp_numpy(p_api.build(base).defs())
    fp["embed"]["table"] *= 0.1
    pmodel = p_api.build(dataclasses.replace(
        base, quant=p_layers.QuantConfig(**quant)))
    pp = p_convert.convert_params(pmodel.init(0, device="cpu"),
                                  convert.fp_params_from_numpy(fp, "cpu"),
                                  4)
    rm = r_api.build(dataclasses.replace(
        r_api.get_smoke_config(arch), quant=r_layers.QuantConfig(**quant)))
    prompts = _prompts(4)
    want, rows = _run(r_engine.Engine(rm, jax_tree(pp), 4, 32),
                      r_engine.Request, prompts, MAX_NEW)
    alone, _ = _run(p_engine.Engine(pmodel, pp, 4, 32, device="cpu"),
                    p_engine.Request, prompts, MAX_NEW)
    return pmodel, pp, prompts, want, rows, alone


def _tokens_agree(want, got, rows, vocab):
    """Greedy tokens equal wherever the reference's top-1 margin exceeds
    TOL, up to the first near tie of each request."""
    compared = 0
    for w, g, rr in zip(want, got, rows):
        for k, (a, b) in enumerate(zip(w.tolist(), g.tolist())):
            top2 = np.sort(rr[k][:vocab])[-2:]
            if top2[1] - top2[0] <= TOL:
                break
            assert a == b
            compared += 1
    return compared


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 2)])
@pytest.mark.parametrize("arch", SERVED)
def test_engine_on_a_tp_mesh_equals_meshless(arch, shape):
    from test_torch_mesh_serve import _run
    pmodel, pp, prompts, want, rows, alone = _served(arch)
    eng = p_engine.Engine(pmodel, pp, 4, 32, device="cpu",
                          mesh=_mesh(*shape))
    got, _ = _run(eng, p_engine.Request, prompts, MAX_NEW)
    assert [g.tolist() for g in got] == [a.tolist() for a in alone]
    assert _tokens_agree(want, got, rows,
                         pmodel.cfg.vocab) >= len(prompts) // 2
    rep = eng.utilization_report()
    assert rep["devices"] == shape[0]


@pytest.mark.parametrize("num_slots", [4, 3])
@pytest.mark.parametrize("shape", [(4, 2), (2, 2)])
def test_scheduler_on_a_tp_mesh_equals_reference(shape, num_slots):
    """Continuous batching on the mesh against the reference's meshless
    `Scheduler`: `tests/test_runtime.py` and `tests/test_engine.py`
    serve the same on (4, tp) meshes."""
    from repro.serve.runtime import scheduler as r_sched
    from repro.serve.runtime.adapters import LMDecodeAdapter as RAdapter
    from test_torch_mesh_serve import _run
    pmodel, pp, prompts, *_ = _served("qwen2.5-3b")
    rm = r_api.build(dataclasses.replace(
        r_api.get_smoke_config("qwen2.5-3b"),
        quant=r_layers.QuantConfig(mode="int", w_bits=4, a_bits=8)))
    want, rows = _run(r_sched.Scheduler(RAdapter(rm, jax_tree(pp), 32),
                                        num_slots), r_engine.Request,
                      prompts, MAX_NEW)
    adapter = p_adapters.LMDecodeAdapter(pmodel, pp, 32, mesh=_mesh(*shape))
    got, _ = _run(p_sched.Scheduler(adapter, num_slots), p_engine.Request,
                  prompts, MAX_NEW)
    assert _tokens_agree(want, got, rows, pmodel.cfg.vocab) >= len(prompts)
    alone, _ = _run(p_sched.Scheduler(p_adapters.LMDecodeAdapter(
        pmodel, pp, 32), num_slots), p_engine.Request, prompts, MAX_NEW)
    assert [g.tolist() for g in got] == [a.tolist() for a in alone]


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_tp_state_is_placed_and_reset(arch):
    """The cache of a (2, 2) mesh: one placed tree per data block, its
    recurrent leaves split over channels; a re-admitted slot's rows are
    zeroed in every part, the others kept."""
    pmodel, pp, *_ = _served(arch)
    ad = p_adapters.LMDecodeAdapter(pmodel, pp, 16, mesh=_mesh(2, 2))
    state = ad.init_state(4)
    assert isinstance(state, p_adapters.TPState) and len(state.blocks) == 2
    key = "ssm" if arch.startswith("mamba") else "rec"
    leaf = next(iter(state.blocks[1][key].values()))
    assert isinstance(leaf, tp.Split) and leaf.parts[0].shape[1] == 2
    live = [t for tree in state.blocks for v in tree[key].values()
            for t in v.parts if t is not None]
    for t in live:
        t.fill_(1.0)
    ad.reset_state(state, np.array([False, False, True, False]))
    for t in leaf.parts:
        if t is not None:
            assert t[:, 0].abs().sum() == 0 and t[:, 1].min() == 1
    for t in next(iter(state.blocks[0][key].values())).parts:
        assert t is None or t.min() == 1


@pytest.mark.parametrize("mesh", ["4,2", "1,2"])
def test_serve_cli_with_model_axis(mesh, capsys):
    args = ["--arch", "qwen2.5-3b", "--smoke", "--quant", "w4a8",
            "--device", "cpu", "--requests", "3", "--batch", "4",
            "--max-new", "3"]
    out = p_serve.main(args + ["--mesh", mesh])
    text = capsys.readouterr().out
    dp, tp_ = mesh.split(",")
    assert f"mesh: data={dp} model={tp_}" in text
    assert "tensor-parallel over 'model'" in text
    meshless = p_serve.main(args)
    capsys.readouterr()
    assert [r.out.tolist() for r in out] == [r.out.tolist()
                                             for r in meshless]


# ----------------------------------------------------------- training ---

def _train_cfgs(arch):
    over = {"compute_dtype": "float32"}
    return (dataclasses.replace(r_api.get_smoke_config(arch), **over),
            dataclasses.replace(p_api.get_smoke_config(arch), **over))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    """The port's model and params, a batch, and the reference's
    meshless loss and gradients at those params."""
    rcfg, pcfg = _train_cfgs(arch)
    rmodel = r_api.build(rcfg)
    rp = rmodel.init(jax.random.PRNGKey(0))
    batch = RSyntheticLM(rcfg.vocab, 4, 16, seed=1)._batch_at(0)
    r_loss, r_g = jax.value_and_grad(rmodel.loss)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    pp = convert.fp_params_from_numpy(np_tree(rp), "cpu")
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    return p_api.build(pcfg), pp, tb, r_loss, r_g


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b", "mamba2-370m"])
def test_loss_and_grads_on_a_tp_mesh_match_the_reference(arch, shape):
    """Each data block's forward split over its model positions; every
    slice's gradient lands in its whole leaf (autograd through the
    slicing)."""
    from repro_torch.nn.module import leaf_paths
    pmodel, pp, tb, r_loss, r_g = _reference_grads(arch)
    p_loss, p_g = loss_and_grads(pmodel, pp, tb, _mesh(*shape))
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=LOSS_RTOL)
    for (path, _), g in zip(leaf_paths(pp), p_g):
        rg = np.asarray(functools.reduce(lambda t, k: t[k], path, r_g),
                        np.float32)
        np.testing.assert_allclose(
            g.numpy(), rg, rtol=0, atol=GRAD_TOL * np.abs(rg).max() + 1e-30,
            err_msg="/".join(path))


def test_moe_grads_on_a_model_axis_match_the_reference():
    """kimi smoke on (1, 2): the experts' gradients come back per expert
    block."""
    rcfg, pcfg = _train_cfgs("kimi-k2-1t-a32b")
    rmodel, pmodel = r_api.build(rcfg), p_api.build(pcfg)
    rp = rmodel.init(jax.random.PRNGKey(0))
    batch = RSyntheticLM(rcfg.vocab, 2, 16, seed=1)._batch_at(0)
    r_loss, r_g = jax.value_and_grad(rmodel.loss)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    pp = convert.fp_params_from_numpy(np_tree(rp), "cpu")
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    p_loss, p_g = loss_and_grads(pmodel, pp, tb, _mesh(1, 2))
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=LOSS_RTOL)
    from repro_torch.nn.module import leaf_paths
    for (path, _), g in zip(leaf_paths(pp), p_g):
        rg = np.asarray(functools.reduce(lambda t, k: t[k], path, r_g),
                        np.float32)
        np.testing.assert_allclose(
            g.numpy(), rg, rtol=0, atol=GRAD_TOL * np.abs(rg).max() + 1e-30,
            err_msg="/".join(path))


TSHAPE = ShapeConfig("t", 16, 4, "train")


def _tcfg():
    return TrainStepConfig(opt=p_opt.OptConfig(lr=1e-3, warmup=1,
                                               total_steps=4))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_train_steps_on_a_tp_mesh_equal_meshless(shape):
    _, pcfg = _train_cfgs("olmo-1b")
    model = p_api.build(pcfg)
    init_fn, step, _ = make_train_fns(model, None, TSHAPE, _tcfg(),
                                      device="cpu")
    _, mstep, shard = make_train_fns(model, _mesh(*shape), TSHAPE, _tcfg(),
                                     device="cpu")
    assert shard["state"] is None
    data = SyntheticLM(pcfg.vocab, 4, 16, seed=3, device="cpu")
    a, b = init_fn(0), init_fn(0)
    for _ in range(2):
        batch = next(data)
        a, ma = step(a, batch)
        b, mb = mstep(b, batch)
        np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                                   rtol=LOSS_RTOL)
    for (path, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-5,
                                   err_msg="/".join(path))


def test_elastic_restore_2x2_to_2x4(tmp_path):
    """`tests/test_elastic.py` in the port: a state stepped and saved on
    a (2, 2) mesh restores and steps on (2, 4), as a meshless run of the
    same steps does."""
    _, pcfg = _train_cfgs("olmo-1b")
    model = p_api.build(pcfg)
    init_fn, step, _ = make_train_fns(model, None, TSHAPE, _tcfg(),
                                      device="cpu")
    _, step22, _ = make_train_fns(model, _mesh(2, 2), TSHAPE, _tcfg(),
                                  device="cpu")
    _, step24, _ = make_train_fns(model, _mesh(2, 4), TSHAPE, _tcfg(),
                                  device="cpu")
    data = SyntheticLM(pcfg.vocab, 4, 16, seed=5, device="cpu")
    b1, b2 = next(data), next(data)
    state, _ = step22(init_fn(0), b1)
    p_ckpt.save(str(tmp_path), 1, state)
    restored, s0 = p_ckpt.restore(str(tmp_path), device="cpu")
    assert s0 == 1
    _, m24 = step24(restored, b2)
    ref, _ = step(init_fn(0), b1)
    _, m = step(ref, b2)
    np.testing.assert_allclose(float(m24["loss"]), float(m["loss"]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_decode_and_prefill_fns_on_a_tp_mesh(shape):
    _, pcfg = _train_cfgs("qwen2.5-3b")
    model = p_api.build(pcfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(pcfg.vocab, shape=(4, 8)))
    mesh = _mesh(*shape)
    prefill, shard = make_prefill_fns(model, mesh,
                                      ShapeConfig("p", 8, 4, "prefill"))
    want, _, _ = model.forward(params, {"tokens": toks})
    _close(_real(prefill(params, {"tokens": toks}).numpy(), pcfg.vocab),
           _real(want[:, -1:].numpy(), pcfg.vocab))
    decode, dshard = make_decode_fns(model, mesh,
                                     ShapeConfig("d", 16, 4, "decode"))
    assert tuple(dshard["cache"]["kv"]["k"].spec)[3] == "model"
    c1 = model.init_cache(4, 16, dtype=torch.float32, device="cpu")
    c2 = model.init_cache(4, 16, dtype=torch.float32, device="cpu")
    for t in range(4):
        a, c1 = model.decode(params, c1, toks[:, t:t + 1], t)
        b, c2 = decode(params, c2, toks[:, t:t + 1], t)
        _close(_real(b.numpy(), pcfg.vocab), _real(a.numpy(), pcfg.vocab))
    _close(c2["kv"]["k"], c1["kv"]["k"])


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
def test_remat_recomputes_under_the_forward_group(arch):
    """With remat, each block's recomputation runs in the backward, which
    autograd may run on a thread of its own (it does on the card): the
    group must still be the forward's there. Here the backward runs on a
    fresh thread, where no context variable of the forward is set; the
    gradients equal the meshless ones."""
    import threading

    from repro_torch.nn.module import leaf_paths, tree_like
    _, pcfg = _train_cfgs(arch)
    model = p_api.build(dataclasses.replace(pcfg, remat=True))
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(_tokens(pcfg.vocab, seed=s, shape=(2, 16)))
             for s, k in enumerate(("tokens", "labels"))}
    paths, leaves = zip(*leaf_paths(params))

    def grads(group):
        req = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad(), tp.tp_scope(group):
            loss = model.loss(tree_like(zip(paths, req)), batch)
        out = {}
        th = threading.Thread(target=lambda: out.setdefault(
            "g", torch.autograd.grad(loss, req)))
        th.start()
        th.join()
        return out["g"]

    want = grads(None)
    got = grads(_group((1, 2)))
    for path, a, b in zip(paths, want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=GRAD_TOL * float(a.abs().max())
                                   + 1e-30, err_msg="/".join(path))
