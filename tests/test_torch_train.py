"""The port's LM training half (`repro_torch.train`, `runtime.trainer`,
`data.pipeline`, the `train` CLI) against the reference, on the CPU.

Tolerances. Exact: the synthetic token batches' bytes. Within a
tolerance (XLA and torch order float32 sums differently): the loss of
the same params and batch (1e-5 relative) and its gradients (1e-4 x each
leaf's largest |g|), at float32 compute; one AdamW update of identical
inputs (params within 1e-6 relative; 8-bit state codes within 1 and
identical on >= 99.9%: a code on a rounding edge may flip).
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as r_ckpt
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models import api as r_api
from repro.train import compress as r_compress
from repro.train import optimizer as r_opt
from repro_torch import convert
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, latest_step,
                                         list_steps, restore, save)
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as p_cli
from repro_torch.launch.mesh import make_cluster_mesh
from repro_torch.models import api as p_api
from repro_torch.nn.module import leaf_paths, tree_like
from repro_torch.runtime.trainer import (StragglerMonitor, Trainer,
                                         TrainerConfig)
from repro_torch.train import optimizer as p_opt
from repro_torch.train.step import (TrainStepConfig, loss_and_grads,
                                    make_decode_fns, make_prefill_fns,
                                    make_train_fns)

from torch_bridge import np_tree

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT_RTOL = 1e-6
ARCHS = ("olmo-1b", "qwen2.5-3b", "mamba2-370m", "kimi-k2-1t-a32b")
SHAPE = ShapeConfig("t", 16, 2, "train")


def _cfgs(arch, **over):
    over = {"compute_dtype": "float32", **over}
    return (dataclasses.replace(r_api.get_smoke_config(arch), **over),
            dataclasses.replace(p_api.get_smoke_config(arch), **over))


def _batch(vocab, seed=1, b=2, s=16):
    return RSyntheticLM(vocab, b, s, seed=seed)._batch_at(0)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------- loss and gradients ---

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    """The train step's loss and gradients (`loss_and_grads`, remat on in
    the port) on the reference's own params and a synthetic batch."""
    rcfg, pcfg = _cfgs(arch, remat=True)
    rmodel, pmodel = r_api.build(rcfg), p_api.build(pcfg)
    rp = rmodel.init(jax.random.PRNGKey(0))
    batch = _batch(rcfg.vocab)
    r_loss, r_g = jax.value_and_grad(rmodel.loss)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    pp = convert.fp_params_from_numpy(np_tree(rp), "cpu")
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    p_loss, p_g = loss_and_grads(pmodel, pp, tb)
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=LOSS_RTOL)
    paths = [p for p, _ in _leaves(pp)]
    assert len(paths) == len(p_g)
    for path, g in zip(paths, p_g):
        rg = np.asarray(_get(r_g, path), np.float32)
        np.testing.assert_allclose(
            g.numpy(), rg, rtol=0, atol=GRAD_TOL * np.abs(rg).max() + 1e-30,
            err_msg="/".join(path))


CUTS = {"olmo-1b": ({"n_layers": 1}, {"layers": 1}),
        "mamba2-370m": ({"n_layers": 1}, {"layers": 1}),
        "recurrentgemma-9b": ({"n_layers": 2}, {"rec_layers": 2,
                                                 "attn_layers": 0}),
        "seamless-m4t-large-v2": ({"enc_layers": 1, "dec_layers": 1},
                                  {"enc_layers": 1, "dec_layers": 1})}


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_forward_of_a_cut_config_runs_its_own_layers(arch):
    """The forward slices its stacked layers once; a config cut to fewer
    layers than its param stacks hold still runs only its own (the
    serving checks run one encoder layer of a full stack this way)."""
    _, pcfg = _cfgs(arch)
    over, keep = CUTS[arch]
    model = p_api.build(pcfg)
    params = model.init(0, device="cpu")
    cut = p_api.build(dataclasses.replace(pcfg, **over))
    sliced = tree_like((p, v[:keep[p[0]]] if p[0] in keep else v)
                       for p, v in leaf_paths(params))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             _batch(pcfg.vocab).items()}
    if pcfg.family == "encdec":
        batch["src_embed"] = torch.randn(2, 8, pcfg.d_model)
    want, _, _ = cut.forward(sliced, batch)
    got, _, _ = cut.forward(params, batch)
    assert torch.equal(got, want)


@pytest.mark.parametrize("state_bits,compress", [(32, 32), (8, 8)])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2.5-3b"])
def test_loss_decreases(arch, state_bits, compress):
    _, pcfg = _cfgs(arch)
    init_fn, step, _ = make_train_fns(
        p_api.build(pcfg), None, SHAPE,
        TrainStepConfig(opt=p_opt.OptConfig(lr=1e-3, warmup=2,
                                            total_steps=30,
                                            state_bits=state_bits),
                        grad_compress_bits=compress), device="cpu")
    batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    state = init_fn(0)
    if compress == 8:
        assert all(v.dtype == torch.bfloat16
                   for _, v in _leaves(state["ef"]))
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_mesh_data_axis_matches_meshless():
    """A (data=2, model=1) mesh of CPU positions splits the batch: loss
    and the updated params agree with the meshless step; a model axis
    above 1 is refused."""
    _, pcfg = _cfgs("qwen2.5-3b")
    model = p_api.build(pcfg)
    tcfg = TrainStepConfig(opt=p_opt.OptConfig(lr=1e-3, warmup=1,
                                               total_steps=4))
    init_fn, step, _ = make_train_fns(model, None, SHAPE, tcfg,
                                      device="cpu")
    mesh = make_cluster_mesh(2, 1, "cpu")
    _, mstep, shard = make_train_fns(model, mesh, SHAPE, tcfg, device="cpu")
    assert tuple(shard["batch"]["tokens"].spec)[0] == "data"
    data = SyntheticLM(pcfg.vocab, 2, 16, seed=3, device="cpu")
    mdata = SyntheticLM(pcfg.vocab, 2, 16, seed=3, mesh=mesh)
    a, b = init_fn(0), init_fn(0)
    for _ in range(2):
        a, ma = step(a, next(data))
        b, mb = mstep(b, next(mdata))
        np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]),
                                   rtol=LOSS_RTOL)
    for (path, x), (_, y) in zip(_leaves(a["params"]),
                                 _leaves(b["params"])):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0,
                                   atol=1e-5, err_msg="/".join(path))
    # a model axis: the same steps, each forward tensor-parallel
    _, tstep, _ = make_train_fns(model, make_cluster_mesh(1, 2, "cpu"),
                                 SHAPE, tcfg, device="cpu")
    c = init_fn(0)
    data = SyntheticLM(pcfg.vocab, 2, 16, seed=3, device="cpu")
    for _ in range(2):
        c, mc = tstep(c, next(data))
    np.testing.assert_allclose(float(mc["loss"]), float(ma["loss"]),
                               rtol=LOSS_RTOL)
    for (path, x), (_, y) in zip(_leaves(a["params"]),
                                 _leaves(c["params"])):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0,
                                   atol=1e-5, err_msg="/".join(path))


def test_decode_and_prefill_fns():
    _, pcfg = _cfgs("qwen2.5-3b")
    model = p_api.build(pcfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(_batch(pcfg.vocab)["tokens"].copy())
    prefill, shard = make_prefill_fns(model, make_cluster_mesh(2, 1, "cpu"),
                                      ShapeConfig("p", 16, 2, "prefill"))
    assert set(shard) == {"params", "batch"}
    want, _, _ = model.forward(params, {"tokens": tokens})
    np.testing.assert_array_equal(prefill(params, {"tokens": tokens}).numpy(),
                                  want[:, -1:].numpy())
    decode, dshard = make_decode_fns(model, make_cluster_mesh(2, 1, "cpu"),
                                     ShapeConfig("d", 16, 2, "decode"))
    assert set(dshard) == {"params", "cache", "token", "index"}
    cache = model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    logits, _ = decode(params, cache, tokens[:, :1], 0)
    assert logits.shape[0] == 2 and torch.isfinite(logits).all()
    # a model axis: decode and prefill tensor-parallel, equal to meshless
    tdecode, tshard = make_decode_fns(model, make_cluster_mesh(1, 2, "cpu"),
                                      ShapeConfig("d", 16, 2, "decode"))
    assert tuple(tshard["cache"]["kv"]["k"].spec)[3] == "model"
    tcache = model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    tlogits, _ = tdecode(params, tcache, tokens[:, :1], 0)
    np.testing.assert_allclose(tlogits.numpy(), logits.numpy(), rtol=0,
                               atol=1e-5 * float(logits[..., :pcfg.vocab]
                                                 .abs().max()))
    tprefill, _ = make_prefill_fns(model, make_cluster_mesh(1, 2, "cpu"),
                                   ShapeConfig("p", 16, 2, "prefill"))
    got = tprefill(params, {"tokens": tokens})[..., :pcfg.vocab]
    np.testing.assert_allclose(got.numpy(), want[:, -1:, :pcfg.vocab].numpy(),
                               rtol=0, atol=1e-5 * float(got.abs().max()))


# ------------------------------------------------------------ optimizer ---

@pytest.mark.parametrize("state_bits", [32, 8])
def test_adamw_update_matches_the_reference(rng, state_bits):
    """Three AdamW updates on identical params and gradients; each
    package carries its own state forward."""
    cfg = r_opt.OptConfig(lr=1e-2, warmup=1, total_steps=10,
                          state_bits=state_bits, clip_norm=0.5)
    pcfg = p_opt.OptConfig(lr=1e-2, warmup=1, total_steps=10,
                           state_bits=state_bits, clip_norm=0.5)
    params = {"w": rng.normal(size=(24, 40)).astype(np.float32),
              "b": {"s": rng.normal(size=(40,)).astype(np.float32),
                    "k": rng.normal(size=(3, 8, 16)).astype(np.float32)}}
    rp = jax.tree.map(jnp.asarray, params)
    pp = convert.fp_params_from_numpy(params, "cpu")
    rs, ps = r_opt.adamw_init(rp, cfg), p_opt.adamw_init(pp, pcfg)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (1 + i))
                         .astype(np.float32), params)
        rp, rs, rm = r_opt.adamw_update(rp, jax.tree.map(jnp.asarray, g),
                                        rs, cfg)
        pp, ps, pm = p_opt.adamw_update(
            pp, convert.fp_params_from_numpy(g, "cpu"), ps, pcfg)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=OPT_RTOL)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=OPT_RTOL)
        for path, x in _leaves(pp):
            np.testing.assert_allclose(x.numpy(), np.asarray(_get(rp, path)),
                                       rtol=OPT_RTOL, atol=1e-7,
                                       err_msg="/".join(path))
        assert int(ps["step"]) == int(rs["step"]) == i + 1
        for path, x in _leaves({"m": ps["m"], "v": ps["v"]}):
            r = np.asarray(_get({"m": rs["m"], "v": rs["v"]}, path))
            if path[-1] == "codes":
                d = np.abs(x.numpy().astype(np.int32) - r.astype(np.int32))
                assert d.max() <= 1 and (d == 0).mean() >= 0.999, path
            else:
                np.testing.assert_allclose(x.numpy(), r, rtol=1e-5,
                                           atol=1e-12, err_msg=str(path))


def test_state_logical_specs_mirror_the_reference():
    specs = {"w": ("embed", "mlp"), "n": {"s": ("embed",)}}
    for bits in (32, 8):
        assert p_opt.state_logical_specs(
            specs, p_opt.OptConfig(state_bits=bits)) == \
            r_opt.state_logical_specs(specs, r_opt.OptConfig(state_bits=bits))


def test_lm_train_state_converts_and_steps_alike(tmp_path):
    """A reference LM train state with 8-bit optimizer state and bfloat16
    error feedback, after one reference step: the port takes it over
    (`convert.train_state_from_numpy`) and both step it once more to the
    same loss."""
    rcfg, pcfg = _cfgs("olmo-1b")
    rmodel, pmodel = r_api.build(rcfg), p_api.build(pcfg)
    ocfg = r_opt.OptConfig(lr=1e-3, warmup=1, total_steps=4, state_bits=8)
    rp = rmodel.init(jax.random.PRNGKey(1))
    state = {"params": rp, "opt": r_opt.adamw_init(rp, ocfg),
             "ef": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.bfloat16),
                                rp)}
    b0, b1 = (RSyntheticLM(rcfg.vocab, 2, 16, seed=2)._batch_at(i)
              for i in (0, 1))

    def r_step(st, batch):
        loss, g = jax.value_and_grad(rmodel.loss)(
            st["params"], {k: jnp.asarray(v) for k, v in batch.items()})
        g, ef = r_compress.compress_grads(g, st["ef"])
        p, o, _ = r_opt.adamw_update(st["params"], g, st["opt"], ocfg)
        return {"params": p, "opt": o, "ef": ef}, loss

    state, _ = r_step(state, b0)
    _, r_loss = r_step(state, b1)
    pstate = convert.train_state_from_numpy(np_tree(state), "cpu")
    assert all(v.dtype == torch.bfloat16 for _, v in _leaves(pstate["ef"]))
    _, step, _ = make_train_fns(
        pmodel, None, SHAPE, TrainStepConfig(
            opt=p_opt.OptConfig(lr=1e-3, warmup=1, total_steps=4,
                                state_bits=8), grad_compress_bits=8),
        device="cpu")
    _, m = step(pstate, SyntheticLM(pcfg.vocab, 2, 16, seed=2,
                                    device="cpu").place(b1))
    np.testing.assert_allclose(float(m["loss"]), float(r_loss),
                               rtol=LOSS_RTOL)
    # float32 / int8 / int32 leaves: the reference's checkpoint restores
    # in the port too
    r_ckpt.save(str(tmp_path), 1, {"params": state["params"],
                                   "opt": state["opt"]})
    back, s = restore(str(tmp_path), device="cpu")
    assert s == 1 and back["opt"]["step"].dtype == torch.int32
    with pytest.raises(ValueError):
        convert.train_state_from_numpy({"params": {}}, "cpu")


# ------------------------------------------------------------------ data ---

@pytest.mark.parametrize("src", [False, True])
def test_synthetic_lm_byte_identical_and_seekable(src):
    kw = dict(src_dim=8, src_len=5) if src else {}
    r = RSyntheticLM(97, 3, 12, seed=4, **kw)
    p = SyntheticLM(97, 3, 12, seed=4, device=None, **kw)
    for _ in range(3):
        rb, pb = next(r), next(p)
        assert set(rb) == set(pb)
        for k in rb:
            assert np.asarray(rb[k]).tobytes() == pb[k].tobytes(), k
    p.seek(1)
    q = SyntheticLM(97, 3, 12, seed=4, device="cpu", **kw)
    q.seek(1)
    nb = next(q)
    assert nb["tokens"].dtype == torch.int32
    assert nb["tokens"].numpy().tobytes() == \
        RSyntheticLM(97, 3, 12, seed=4, **kw)._batch_at(1)[
            "tokens"].tobytes()
    mesh = make_cluster_mesh(3, 1, "cpu")
    sh = SyntheticLM(97, 3, 12, seed=4, mesh=mesh)
    parts = next(sh)["tokens"].shards
    assert [t.shape for t in parts] == [(1, 12)] * 3


# --------------------------------------------------------------- trainer ---

def _trainer_setup(tmp, total, every, seed=1):
    _, pcfg = _cfgs("qwen2.5-3b")
    init_fn, step, _ = make_train_fns(
        p_api.build(pcfg), None, SHAPE,
        TrainStepConfig(opt=p_opt.OptConfig(lr=1e-3, warmup=2,
                                            total_steps=30)), device="cpu")
    data = SyntheticLM(pcfg.vocab, 2, 16, seed=seed, device="cpu")
    return init_fn, step, data, TrainerConfig(total_steps=total,
                                              ckpt_every=every, ckpt_dir=tmp)


def test_trainer_restart_resume(tmp_path):
    init_fn, step, data, cfg = _trainer_setup(str(tmp_path), 12, 6)
    _, log = Trainer(init_fn, step, data, cfg, device="cpu").run(0)
    assert log[-1]["step"] == 12 and list_steps(str(tmp_path)) == [6, 12]
    init_fn, step, data2, cfg2 = _trainer_setup(str(tmp_path), 18, 6)
    tr = Trainer(init_fn, step, data2, cfg2, device="cpu")
    _, log2 = tr.run(0)
    assert tr.restored_step == 12 and log2[0]["step"] == 13  # resumed
    assert data2.step == 18 and tr.restore_s > 0
    saved = tr.ckpt.last_save
    assert saved["step"] == 18 and saved["write_s"] > 0
    assert saved["bytes"] == sum(t.numel() * t.element_size()
                                 for _, t in leaf_paths(restore(
                                     str(tmp_path), device="cpu")[0]))


def test_trainer_restores_and_replays_after_a_failure(tmp_path):
    """A step that raises (a device fault) restores the latest checkpoint
    and replays from it, the batches seeked back: the replayed losses
    equal the uninterrupted run's."""
    init_fn, step, data, cfg = _trainer_setup(str(tmp_path / "a"), 8, 4)
    _, clean = Trainer(init_fn, step, data, cfg, device="cpu").run(0)
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("CUDA error: an illegal memory access")
        return step(state, batch)

    init_fn, _, data, cfg = _trainer_setup(str(tmp_path / "b"), 8, 4)
    tr = Trainer(init_fn, flaky, data, cfg, device="cpu")
    _, log = tr.run(0)
    assert [r["step"] for r in log] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    assert tr.restored_step == 4
    np.testing.assert_allclose([r["loss"] for r in log[6:]],
                               [r["loss"] for r in clean[4:]], rtol=1e-6)


def test_trainer_checkpoints_on_sigterm(tmp_path):
    """A preemption notice (SIGTERM) mid-run: the step in flight ends, a
    synchronous checkpoint is written at it, and the run stops."""
    import os
    import signal
    init_fn, step, data, cfg = _trainer_setup(str(tmp_path), 12, 100)

    def preempted(state, batch):
        out = step(state, batch)
        if data.step == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    prev = signal.getsignal(signal.SIGTERM)
    try:
        _, log = Trainer(init_fn, preempted, data, cfg, device="cpu").run(0)
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert log[-1]["step"] == 3 and list_steps(str(tmp_path)) == [3]


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4))}}
    save(tmp_path, 5, tree)
    got, s = restore(tmp_path, device="cpu")
    assert s == 5 and torch.equal(got["a"], tree["a"])
    ck = AsyncCheckpointer(tmp_path, keep=2)
    for s in (6, 7, 8):
        ck.save_async(s, tree)
        ck.wait()
    assert latest_step(tmp_path) == 8 and len(list_steps(tmp_path)) <= 2
    (tmp_path / "step_00000009.tmp").mkdir()     # a crashed writer
    assert latest_step(tmp_path) == 8


def test_straggler_monitor():
    m = StragglerMonitor(factor=2.0)
    for _ in range(10):
        assert not m.record(0.1)
    assert m.record(0.5)        # 5x median -> flagged
    assert m.flags == 1 and m.median == pytest.approx(0.1)


# ------------------------------------------------------------------- CLI ---

def test_cli_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "olmo-1b", "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt", str(tmp_path / "c"),
            "--ckpt-every", "2", "--warmup", "1"]
    out = p_cli.main(args)
    assert [r["step"] for r in out["log"]] == [1, 2, 3, 4]
    shutil.rmtree(tmp_path / "c" / "step_00000004")    # cut after step 2
    out2 = p_cli.main(args)
    assert out2["trainer"].restored_step == 2
    assert [r["step"] for r in out2["log"]] == [3, 4]
    np.testing.assert_allclose([r["loss"] for r in out2["log"]],
                               [r["loss"] for r in out["log"][2:]],
                               rtol=1e-6)
    assert "resumed at step 2" in capsys.readouterr().out
    for extra in (["--opt-state-bits", "8"], ["--qat", "w4a8"]):
        o = p_cli.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--device", "cpu",
                        "--ckpt", str(tmp_path / extra[0])] + extra)
        assert np.isfinite([r["loss"] for r in o["log"]]).all()
    with pytest.raises(SystemExit):
        p_cli.main(["--arch", "olmo-1b", "--mesh", "pod"])


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pcfg = _cfgs("olmo-1b")
    init_fn, _, _ = make_train_fns(p_api.build(pcfg), None, SHAPE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_fn(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(pcfg.vocab, 2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_cli.main(["--arch", "olmo-1b", "--smoke"])
