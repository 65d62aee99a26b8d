"""LM tensor parallelism on a (pod, data, model) mesh, the shape of the
reference's multipod mesh: a data block is one (pod, data) pair, its
tensor-parallel group that block's model positions, and a batch splits
over every block. Held against meshless with the tolerances of
`tests/test_torch_tp_models.py`.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import convert as p_convert
from repro_torch.models import api as p_api
from repro_torch.nn import layers as p_layers
from repro_torch.nn.module import leaf_paths
from repro_torch.parallel import mesh as pm
from repro_torch.parallel import tp
from repro_torch.parallel.ctx import use_mesh
from repro_torch.serve import engine as p_engine
from repro_torch.train.step import (loss_and_grads, make_decode_fns,
                                    make_prefill_fns)

from test_torch_lm import LOGIT_RTOL, _real, _tokens
from test_torch_tp_models import (B, GRAD_TOL, LOSS_RTOL, MAX_NEW, S,
                                  _close, _reference, _reference_grads,
                                  _train_cfgs)
from torch_bridge import fp_numpy

POD_MESHES = [(2, 2, 2), (2, 1, 2)]
ARCHS = ["qwen2.5-3b", "mamba2-370m"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pod_mesh(shape):
    return pm.make_mesh(shape, ("pod", "data", "model"), "cpu")


@pytest.mark.parametrize("shape", POD_MESHES)
def test_data_blocks_of_a_pod_mesh(shape):
    """One block per (pod, data) pair, in the batch's (pod, data) order;
    each block's group is its own model positions."""
    mesh = _pod_mesh(shape)
    pods, data, model = shape
    blocks = pm.data_blocks(mesh)
    assert blocks == [b * model for b in range(pods * data)]
    assert pm.block_entry(mesh) == ("pod", "data")
    for b, first in enumerate(blocks):
        grp = tp.TPGroup(mesh, b)
        assert grp.positions == list(range(first, first + model))
        assert grp.m == model
        assert {pm.block_of(mesh, p) for p in grp.positions} == {b}
    two = pm.make_mesh((4, 2), ("data", "model"), "cpu")
    assert pm.data_blocks(two) == pm.axis_positions(two, "data")
    assert pm.block_entry(two) == "data"


@pytest.mark.parametrize("shape", POD_MESHES)
@pytest.mark.parametrize("bits", [None, 4], ids=["fp", "w4a8"])
@pytest.mark.parametrize("mod", ["qwen2p5_3b", "mamba2_370m"])
def test_model_forward_and_decode_on_a_pod_mesh(mod, bits, shape):
    """`Model.forward` under the pod mesh, then decode over the params
    and cache placed on the last block's group, against the reference's
    meshless logits."""
    pm_, pp, toks, _, fwd, steps = _reference(mod, bits)
    cfg = pm_.cfg
    tol = LOGIT_RTOL * np.abs(fwd).max()
    batch = {"tokens": torch.from_numpy(toks)}
    mesh = _pod_mesh(shape)
    with use_mesh(mesh):
        got = _real(pm_.forward(pp, batch)[0].numpy(), cfg.vocab)
    np.testing.assert_allclose(got, fwd, atol=tol)
    grp = tp.TPGroup(mesh, len(pm.data_blocks(mesh)) - 1)
    placed = pm_.place(pp, grp)
    cache = pm_.place_cache(pm_.init_cache(B, 16, torch.float32,
                                           device="cpu"), grp)
    with tp.tp_scope(grp):
        for t in range(S):
            lg, cache = pm_.decode(placed, cache, torch.from_numpy(
                toks[:, t:t + 1]), torch.full((B,), t))
            np.testing.assert_allclose(_real(lg.numpy(), cfg.vocab),
                                       steps[t], atol=tol)


@pytest.mark.parametrize("shape", POD_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_fns_on_a_pod_mesh(arch, shape):
    """The step builders split the rows over all four (or two) blocks and
    run each block tensor-parallel: equal to meshless."""
    _, pcfg = _train_cfgs(arch)
    model = p_api.build(pcfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(_tokens(pcfg.vocab, shape=(4, 8)))
    mesh = _pod_mesh(shape)
    prefill, shard = make_prefill_fns(model, mesh,
                                      ShapeConfig("p", 8, 4, "prefill"))
    assert tuple(shard["batch"]["tokens"].spec)[0] == ("pod", "data")
    want, _, _ = model.forward(params, {"tokens": toks})
    _close(_real(prefill(params, {"tokens": toks}).numpy(), pcfg.vocab),
           _real(want[:, -1:].numpy(), pcfg.vocab))
    decode, _ = make_decode_fns(model, mesh,
                                ShapeConfig("d", 16, 4, "decode"))
    c1 = model.init_cache(4, 16, dtype=torch.float32, device="cpu")
    c2 = model.init_cache(4, 16, dtype=torch.float32, device="cpu")
    for t in range(4):
        a, c1 = model.decode(params, c1, toks[:, t:t + 1], t)
        b, c2 = decode(params, c2, toks[:, t:t + 1], t)
        _close(_real(b.numpy(), pcfg.vocab), _real(a.numpy(), pcfg.vocab))


@functools.lru_cache(maxsize=None)
def _w4a8(arch):
    """A W4A8 smoke model and params from seeded numpy weights, and its
    meshless `Engine` tokens."""
    from test_torch_mesh_serve import _prompts, _run
    base = p_api.get_smoke_config(arch)
    fp = fp_numpy(p_api.build(base).defs())
    fp["embed"]["table"] *= 0.1
    model = p_api.build(dataclasses.replace(
        base, quant=p_layers.QuantConfig(mode="int", w_bits=4, a_bits=8)))
    params = p_convert.convert_params(
        model.init(0, device="cpu"),
        convert.fp_params_from_numpy(fp, "cpu"), 4)
    prompts = _prompts(4)
    alone, _ = _run(p_engine.Engine(model, params, 4, 32, device="cpu"),
                    p_engine.Request, prompts, MAX_NEW)
    return model, params, prompts, alone


@pytest.mark.parametrize("shape", POD_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_a_pod_mesh_equals_meshless(arch, shape):
    """W4A8 served over every (pod, data) block: the same tokens."""
    from test_torch_mesh_serve import _run
    model, params, prompts, alone = _w4a8(arch)
    eng = p_engine.Engine(model, params, 4, 32, device="cpu",
                          mesh=_pod_mesh(shape))
    got, _ = _run(eng, p_engine.Request, prompts, MAX_NEW)
    assert [g.tolist() for g in got] == [a.tolist() for a in alone]
    assert eng.utilization_report()["devices"] == shape[0] * shape[1]


@pytest.mark.parametrize("shape", POD_MESHES)
def test_loss_and_grads_on_a_pod_mesh_match_the_reference(shape):
    """The batch's rows over every (pod, data) block, each block's
    forward split over its model positions."""
    pmodel, pp, tb, r_loss, r_g = _reference_grads("qwen2.5-3b")
    p_loss, p_g = loss_and_grads(pmodel, pp, tb, _pod_mesh(shape))
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=LOSS_RTOL)
    for (path, _), g in zip(leaf_paths(pp), p_g):
        rg = np.asarray(functools.reduce(lambda t, k: t[k], path, r_g),
                        np.float32)
        np.testing.assert_allclose(
            g.numpy(), rg, rtol=0, atol=GRAD_TOL * np.abs(rg).max() + 1e-30,
            err_msg="/".join(path))
