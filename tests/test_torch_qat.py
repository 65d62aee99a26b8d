"""The port's QAT subsystem (`repro_torch.qat`, the int8 codecs,
task-loss calibration, the `qat` CLI) against the reference, on the CPU.

Tolerances. Exact: every fake-quant function's values and gradients
(straight-through and PACT, exact ties included) at W{8,4,2}, the int8
codecs, the datasets' bytes, deployed artifacts and integer logits of one
trained state. Within a tolerance (float32 convs order their sums
differently in XLA and in torch): the QAT forward's logits (1e-5 x the
largest |logit|), its fake-quanted edge codes (1 LSB everywhere,
identical on >= 99.9%), one step's loss and EMA ranges (1e-6 relative),
its gradients (1e-4 x each leaf's largest |g|), and the task-loss
sensitivities (1e-4 relative, or 1e-6 absolute: a sensitivity is the
difference of two float32 mean losses near 2.3, whose last bit is
2.4e-7, so a W8 sensitivity of ~3e-4 can move 4e-4 relative on one ulp;
a column's share of it 1e-6 over the layer's channels).
"""
import gzip
import importlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as r_ckpt
from repro.deploy import calibrate as r_cal
from repro.deploy import planner as r_plan
from repro.qat import data as r_data
from repro.qat import fakequant as r_fq
from repro.qat import train as r_train
from repro.train import optimizer as r_opt
from repro.vision import models as r_models
from repro.vision.configs import get_vision_config as r_config
from repro_torch import convert
from repro_torch.deploy import calibrate as p_cal
from repro_torch.deploy import planner as p_plan
from repro_torch.deploy.policy import PlanRule, PrecisionPlan
from repro_torch.launch import qat as p_cli
from repro_torch.qat import data as p_data
from repro_torch.qat import evaluate as p_eval
from repro_torch.qat import fakequant as p_fq
from repro_torch.qat import train as p_train
from repro_torch.vision import models as p_models
from repro_torch.vision.configs import get_vision_config as p_config

from torch_bridge import assert_artifacts_equal, np_tree

r_quant = importlib.import_module("repro.core.quantize")
p_quant = importlib.import_module("repro_torch.core.quantize")

BITS = (8, 4, 2)
LOGIT_TOL = 1e-5      # x max |logit|
GRAD_TOL = 1e-4       # x each leaf's max |g|
LOSS_RTOL = 1e-6
SENS_RTOL = 1e-4
SENS_ATOL = 1e-6      # ~4 float32 ulps of a mean loss near 2.3


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def exact(port, ref, what=""):
    p = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_array_equal(np.asarray(p), np.asarray(ref),
                                  err_msg=what)


# ------------------------------------------------------ fake-quant codecs ---

def _tied(rng, eps, lo, hi, n=61):
    """Values off the grid plus exact ties at lo*eps, hi*eps and 0."""
    v = rng.normal(size=n).astype(np.float32) * hi * eps
    v[:3] = np.float32(lo) * np.float32(eps), np.float32(hi) * np.float32(
        eps), 0.0
    return v


@pytest.mark.parametrize("bits", BITS)
def test_ste_quantize_values_and_gradient_exact(rng, bits):
    hi = (1 << (bits - 1)) - 1
    eps = np.float32(0.037)
    v = _tied(rng, eps, -hi, hi)
    cot = rng.normal(size=v.shape).astype(np.float32)
    r_val, r_vjp = jax.vjp(lambda x: r_fq.ste_quantize(x, jnp.float32(eps),
                                                       -hi, hi),
                           jnp.asarray(v))
    x = t(v).requires_grad_(True)
    p_val = p_fq.ste_quantize(x, torch.tensor(eps), -hi, hi)
    p_val.backward(t(cot))
    exact(p_val, r_val)
    exact(x.grad, r_vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_weight_values_and_gradient_exact(rng, bits,
                                                     per_channel):
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    if per_channel:
        w = w.reshape(72, 16)
    w[0, 0] = np.abs(w).max()             # a weight on the clip edge
    cot = rng.normal(size=w.shape).astype(np.float32)
    r_val, r_vjp = jax.vjp(lambda a: r_fq.fake_quant_weight(
        a, bits, per_channel=per_channel), jnp.asarray(w))
    x = t(w).requires_grad_(True)
    p_val = p_fq.fake_quant_weight(x, bits, per_channel=per_channel)
    p_val.backward(t(cot))
    exact(p_val, r_val)
    exact(x.grad, r_vjp(jnp.asarray(cot))[0])


def test_fake_quant_weight_segmented_exact(rng):
    w = rng.normal(size=(3, 3, 4, 12)).astype(np.float32)
    runs = ((0, 5, 8), (5, 9, 4), (9, 12, 2))
    cot = rng.normal(size=w.shape).astype(np.float32)
    r_val, r_vjp = jax.vjp(lambda a: r_fq.fake_quant_weight_segmented(
        a, runs), jnp.asarray(w))
    x = t(w).requires_grad_(True)
    p_val = p_fq.fake_quant_weight_segmented(x, runs)
    p_val.backward(t(cot))
    exact(p_val, r_val)
    exact(x.grad, r_vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("learned", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_fake_quant_act_values_and_gradients_exact(rng, bits, learned):
    """EMA and PACT, with inputs on exact ties: x == beta and x == 0 (the
    reference's clip splits the tie's gradient in halves). beta is given
    per element, so d/dbeta is per element too and compared exactly; a
    scalar beta's gradient is the sum of these, which XLA and torch add
    in different orders (within 1e-6 relative)."""
    beta = np.float32(1.7)
    x = rng.uniform(-0.5, 2.5, size=(128,)).astype(np.float32)
    x[:4] = beta, 0.0, beta, 0.0
    cot = rng.normal(size=x.shape).astype(np.float32)
    for b_shape in (x.shape, ()):
        b = np.full(b_shape, beta, np.float32)
        r_val, r_vjp = jax.vjp(lambda a, bb: r_fq.fake_quant_act(
            a, bb, bits, learned=learned), jnp.asarray(x), jnp.asarray(b))
        r_dx, r_db = r_vjp(jnp.asarray(cot))
        px = t(x).requires_grad_(True)
        pb = t(b).requires_grad_(True)
        p_val = p_fq.fake_quant_act(px, pb, bits, learned=learned)
        p_val.backward(t(cot))
        exact(p_val, r_val)
        exact(px.grad, r_dx, "dx")
        if not learned:
            assert pb.grad is None and not np.asarray(r_db).any()
        elif b_shape:
            exact(pb.grad, r_db, "dbeta")
        else:
            np.testing.assert_allclose(pb.grad.numpy(), r_db, rtol=1e-6)


def test_range_helpers_exact(rng):
    z = np.zeros((4, 4), np.float32)
    exact(p_fq.weight_absmax(t(z)), r_fq.weight_absmax(jnp.asarray(z)))
    w = rng.normal(size=(5, 7)).astype(np.float32)
    for pc in (False, True):
        exact(p_fq.weight_absmax(t(w), per_channel=pc),
              r_fq.weight_absmax(jnp.asarray(w), per_channel=pc))
    exact(p_fq.batch_absmax(t(w)), r_fq.batch_absmax(jnp.asarray(w)))
    for prev, obs in ((0.0, 2.0), (2.0, 1.0), (1.3, 0.7)):
        exact(p_fq.ema_update(torch.tensor(np.float32(prev)),
                              torch.tensor(np.float32(obs)), 0.9),
              r_fq.ema_update(jnp.float32(prev), jnp.float32(obs), 0.9))


# ------------------------------------------------------------ int8 codecs ---

CODEC_CASES = [np.zeros((4, 8), np.float32),
               np.ones((3, 300), np.float32) * 1e-15,
               np.linspace(-5, 5, 257, dtype=np.float32)[None, :],
               np.random.default_rng(3).normal(size=(7, 33)).astype(
                   np.float32) * 3.0]


@pytest.mark.parametrize("case", range(len(CODEC_CASES)))
def test_int8_codecs_exact(case):
    x = CODEC_CASES[case]
    r = r_quant.quantize_int8_rowwise(jnp.asarray(x))
    p = p_quant.quantize_int8_rowwise(t(x))
    exact(p["codes"], r["codes"])
    exact(p["scale"], r["scale"])
    exact(p_quant.dequantize_int8_rowwise(p),
          r_quant.dequantize_int8_rowwise(r))
    rc, rs = r_quant.quantize_int8_blockwise(jnp.asarray(x))
    pc, ps = p_quant.quantize_int8_blockwise(t(x))
    exact(pc, rc)
    exact(ps, rs)
    exact(p_quant.dequantize_int8_blockwise(pc, ps, x.shape),
          r_quant.dequantize_int8_blockwise(rc, rs, x.shape))
    assert p_quant.BLOCK == r_quant.BLOCK


def test_compress_grads_exact(rng):
    from repro.train.compress import compress_grads as r_compress
    from repro_torch.train.compress import compress_grads as p_compress
    g = {"a": rng.normal(size=(10, 100)).astype(np.float32),
         "b": {"c": rng.normal(size=(3, 7)).astype(np.float32)}}
    ef = {"a": rng.normal(size=(10, 100)).astype(np.float32) * 1e-3,
          "b": {"c": np.zeros((3, 7), np.float32)}}
    rq, ref_ef = r_compress(jax.tree.map(jnp.asarray, g),
                            jax.tree.map(jnp.asarray, ef))
    pq, p_ef = p_compress(convert.fp_params_from_numpy(g, "cpu"),
                          convert.fp_params_from_numpy(ef, "cpu"))
    for path in (("a",), ("b", "c")):
        exact(_get(pq, path), _get(rq, path))
        exact(_get(p_ef, path), _get(ref_ef, path))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ----------------------------------------------------------------- data ---

@pytest.mark.parametrize("split,seed,noise,jitter",
                         [("train", 0, 0.18, 2), ("test", 3, 0.45, 3),
                          ("val", 1, 0.0, 0)])
def test_synthetic_digits_byte_identical(split, seed, noise, jitter):
    r = r_data.SyntheticDigits(split=split, seed=seed, noise=noise,
                               jitter=jitter)
    p = p_data.SyntheticDigits(split=split, seed=seed, noise=noise,
                               jitter=jitter)
    for (rx, ry), (px, py) in zip(r.batches(16, 3), p.batches(16, 3)):
        assert rx.tobytes() == px.tobytes() and ry.tobytes() == py.tobytes()
    rm = next(r_data.make_dataset("synthetic", split=split,
                                  seed=seed).batches(8, 1))
    pm = next(p_data.make_dataset("synthetic", split=split,
                                  seed=seed).batches(8, 1))
    assert rm[0].tobytes() == pm[0].tobytes()
    with pytest.raises(KeyError):
        p_data.make_dataset("imagenet")
    with pytest.raises(ValueError):
        p_data.make_dataset("mnist")


def _write_idx(path, arr):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("idx")
    rng = np.random.default_rng(5)
    for stem, n in (("train", 40), ("t10k", 20)):
        _write_idx(d / f"{stem}-images-idx3-ubyte.gz",
                   rng.integers(0, 256, size=(n, 28, 28)))
        _write_idx(d / f"{stem}-labels-idx1-ubyte.gz",
                   rng.integers(0, 10, size=(n,)))
    return d


@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_digits_from_idx_files_byte_identical(mnist_dir, split):
    r = r_data.make_dataset("mnist", split=split, seed=2,
                            data_dir=str(mnist_dir))
    p = p_data.make_dataset("mnist", split=split, seed=2,
                            data_dir=str(mnist_dir))
    for (rx, ry), (px, py) in zip(r.batches(6, 2), p.batches(6, 2)):
        assert px.shape == (6, 16, 16, 1) and px.dtype == np.float32
        assert rx.tobytes() == px.tobytes() and ry.tobytes() == py.tobytes()


# ---------------------------------------- the QAT forward and one step ---

@pytest.fixture(scope="module")
def smoke():
    """qat-cnn-smoke from the reference's unit-bn init, its ranges seeded
    from one batch, in both packages."""
    rcfg, pcfg = r_config("qat-cnn", smoke=True), p_config("qat-cnn",
                                                           smoke=True)
    rp = r_models.init_fp(rcfg, seed=0)
    for L in rcfg.layers:
        if L.kind in ("conv", "dwconv"):
            node = r_models.get_path(rp, L.path)
            node["bn_scale"] = jnp.ones_like(node["bn_scale"])
    x, y = next(r_data.SyntheticDigits(seed=0).batches(16, 1))
    _, obs0 = r_train.qat_forward(rcfg, rp, jnp.asarray(x), {}, lquant=None,
                                  a_bits=8)
    absmax = {k: np.float32(obs0[k]) for k in r_train._absmax_paths(rcfg)}
    return dict(rcfg=rcfg, pcfg=pcfg, rp=rp, pp=convert.fp_params_from_numpy(
        np_tree(rp), "cpu"), x=x, y=y, absmax=absmax)


@pytest.mark.parametrize("w_bits", BITS)
def test_qat_forward_logits_and_edge_codes(smoke, w_bits):
    rcfg, pcfg = smoke["rcfg"], smoke["pcfg"]
    rlq = r_train.resolve_layer_quant(rcfg, None, w_bits, 8)
    plq = p_train.resolve_layer_quant(pcfg, None, w_bits, 8)
    assert {k: (v.w_bits, v.segments) for k, v in plq.items()} == \
        {k: (v.w_bits, v.segments) for k, v in rlq.items()}
    r_edges, p_edges = {}, {}
    r_logits, r_obs = r_train.qat_forward(
        rcfg, smoke["rp"], jnp.asarray(smoke["x"]),
        {k: jnp.float32(v) for k, v in smoke["absmax"].items()},
        lquant=rlq, a_bits=8, edge_tap=lambda p, v: r_edges.setdefault(p, v))
    p_logits, p_obs = p_train.qat_forward(
        pcfg, smoke["pp"], t(smoke["x"]),
        {k: torch.tensor(v) for k, v in smoke["absmax"].items()},
        lquant=plq, a_bits=8, edge_tap=lambda p, v: p_edges.setdefault(p, v))
    r_logits = np.asarray(r_logits)
    np.testing.assert_allclose(p_logits.numpy(), r_logits, rtol=0,
                               atol=LOGIT_TOL * np.abs(r_logits).max())
    assert set(p_edges) == set(r_edges) and set(p_obs) == set(r_obs)
    total = same = 0
    for path, rv in r_edges.items():
        eps = np.float32(max(smoke["absmax"][path], 1e-6)) / np.float32(255)
        rc = np.round(np.asarray(rv) / eps).astype(np.int64)
        pc = np.round(p_edges[path].numpy() / eps).astype(np.int64)
        assert np.abs(rc - pc).max() <= 1, path
        total += rc.size
        same += int((rc == pc).sum())
    assert same >= 0.999 * total


def _ref_grads(rcfg, rp, absmax, x, y, rlq):
    def loss(p):
        logits, _ = r_train.qat_forward(
            rcfg, p, x, {k: jnp.float32(v) for k, v in absmax.items()},
            lquant=rlq, a_bits=8)
        return r_train.cross_entropy(logits, y)
    return jax.value_and_grad(loss)(rp)


@pytest.mark.parametrize("w_bits", [4, None])
def test_qat_step_loss_grads_and_ranges(smoke, w_bits):
    """One `make_qat_step` from the same state and batch: loss and EMA
    ranges within 1e-6 relative; the gradients (the reference's
    `value_and_grad` of the same loss) within 1e-4 x each leaf's max |g|.
    """
    rcfg, pcfg = smoke["rcfg"], smoke["pcfg"]
    qc = r_train.QATConfig(steps=10, batch=16, w_bits=w_bits, warmup=2)
    pqc = p_train.QATConfig(steps=10, batch=16, w_bits=w_bits, warmup=2)
    rlq = (None if w_bits is None
           else r_train.resolve_layer_quant(rcfg, None, w_bits, 8))
    plq = (None if w_bits is None
           else p_train.resolve_layer_quant(pcfg, None, w_bits, 8))
    ropt = r_opt.OptConfig(lr=qc.lr, warmup=2, total_steps=10,
                           weight_decay=qc.weight_decay)
    popt = p_train.OptConfig(lr=qc.lr, warmup=2, total_steps=10,
                             weight_decay=qc.weight_decay)
    x, y = jnp.asarray(smoke["x"]), jnp.asarray(smoke["y"])
    r_state = {"params": smoke["rp"],
               "absmax": {k: jnp.float32(v)
                          for k, v in smoke["absmax"].items()},
               "opt": r_opt.adamw_init(smoke["rp"], ropt)}
    r_new, r_m = jax.jit(r_train.make_qat_step(rcfg, qc, rlq, ropt))(
        r_state, {"x": x, "y": y})
    p_state = convert.train_state_from_numpy(np_tree(r_state), "cpu")
    p_new, p_m = p_train.make_qat_step(pcfg, pqc, plq, popt)(
        p_state, {"x": t(smoke["x"]), "y": torch.from_numpy(smoke["y"])})
    np.testing.assert_allclose(float(p_m["loss"]), float(r_m["loss"]),
                               rtol=LOSS_RTOL)
    assert float(p_m["acc"]) == float(r_m["acc"])
    for k, v in r_new["absmax"].items():
        np.testing.assert_allclose(float(p_new["absmax"][k]), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert int(p_new["opt"]["step"]) == int(r_new["opt"]["step"]) == 1

    _, r_g = _ref_grads(rcfg, smoke["rp"], smoke["absmax"], x, y, rlq)
    p_params = {k: v for k, v in p_state["params"].items()}
    leaves = p_train.leaf_paths(p_params)
    req = [v.clone().requires_grad_(True) for _, v in leaves]
    tree = p_train.tree_like(zip((q for q, _ in leaves), req))
    logits, _ = p_train.qat_forward(
        pcfg, tree, t(smoke["x"]),
        {k: torch.tensor(v) for k, v in smoke["absmax"].items()},
        lquant=plq, a_bits=8)
    grads = torch.autograd.grad(
        p_train.cross_entropy(logits, torch.from_numpy(smoke["y"])), req)
    for (path, _), g in zip(leaves, grads):
        rg = np.asarray(_get(r_g, path))
        np.testing.assert_allclose(g.numpy(), rg, rtol=0,
                                   atol=GRAD_TOL * np.abs(rg).max() + 1e-30,
                                   err_msg="/".join(path))


def test_pact_step_gradient_reaches_the_ranges(smoke):
    """learned_absmax: the ranges are leaves under ACT_KEY and take
    gradients; the loss matches the reference's step."""
    rcfg, pcfg = smoke["rcfg"], smoke["pcfg"]
    qc = r_train.QATConfig(steps=4, batch=16, w_bits=4, warmup=1,
                           learned_absmax=True)
    pqc = p_train.QATConfig(steps=4, batch=16, w_bits=4, warmup=1,
                            learned_absmax=True)
    rp = dict(smoke["rp"])
    rp[r_train.ACT_KEY] = {k: jnp.float32(v)
                           for k, v in smoke["absmax"].items()}
    ropt = r_opt.OptConfig(lr=qc.lr, warmup=1, total_steps=4,
                           weight_decay=qc.weight_decay)
    rlq = r_train.resolve_layer_quant(rcfg, None, 4, 8)
    r_state = {"params": rp, "absmax": rp[r_train.ACT_KEY],
               "opt": r_opt.adamw_init(rp, ropt)}
    r_new, r_m = jax.jit(r_train.make_qat_step(rcfg, qc, rlq, ropt))(
        r_state, {"x": jnp.asarray(smoke["x"]),
                  "y": jnp.asarray(smoke["y"])})
    p_state = convert.train_state_from_numpy(np_tree(r_state), "cpu")
    p_new, p_m = p_train.make_qat_step(
        pcfg, pqc, p_train.resolve_layer_quant(pcfg, None, 4, 8),
        p_train.OptConfig(lr=qc.lr, warmup=1, total_steps=4,
                          weight_decay=qc.weight_decay))(
        p_state, {"x": t(smoke["x"]), "y": torch.from_numpy(smoke["y"])})
    np.testing.assert_allclose(float(p_m["loss"]), float(r_m["loss"]),
                               rtol=LOSS_RTOL)
    moved = [k for k, v in p_new["params"][p_train.ACT_KEY].items()
             if float(v) != float(p_state["params"][p_train.ACT_KEY][k])]
    r_moved = [k for k, v in r_new["params"][r_train.ACT_KEY].items()
               if float(v) != float(rp[r_train.ACT_KEY][k])]
    assert moved == r_moved and moved


# --------------------------------------------- training and deployment ---

SEG_PLAN = (("c3", 8, ((0, 128, 8), (128, 256, 2))), ("c1", 2, None))


def _plans():
    r_pol = importlib.import_module("repro.deploy.policy")
    rules = tuple(PlanRule(pattern=p, w_bits=b, segments=s)
                  for p, b, s in SEG_PLAN)
    r_rules = tuple(r_pol.PlanRule(pattern=p, w_bits=b, segments=s)
                    for p, b, s in SEG_PLAN)
    return (PrecisionPlan(rules=rules, default_w_bits=4),
            r_pol.PrecisionPlan(rules=r_rules, default_w_bits=4))


@pytest.fixture(scope="module", params=["uniform_w4", "segmented"])
def trained(request):
    """The port trains full-width qat-cnn for 20 steps (uniform W4, or
    under a plan whose c3 runs W8 | W2 and c1 W2); the reference packs the
    same trained params and ranges."""
    seg = request.param == "segmented"
    cfg, rcfg = p_config("qat-cnn"), r_config("qat-cnn")
    plan, rplan = _plans() if seg else (None, None)
    qc = p_train.QATConfig(steps=20, batch=16, w_bits=4, warmup=3,
                           log_every=19, seed=0)
    res = p_train.train_qat(cfg, p_data.make_dataset("synthetic", seed=0),
                            qc, plan=plan, device="cpu")
    return dict(res=res, cfg=cfg, rcfg=rcfg, plan=plan, rplan=rplan)


def test_train_qat_loss_falls_and_folds(trained):
    res = trained["res"]
    assert res.log[-1]["loss"] < res.log[0]["loss"]
    assert np.isfinite([r["loss"] for r in res.log]).all()
    p_eval.fold_check(res)
    if trained["plan"] is not None:
        assert res.lquant["c3"].segments == ((0, 128, 8), (128, 256, 2))
        assert res.lquant["c1"].w_bits == 2 and res.lquant["c2"].w_bits == 4


def test_deploy_and_evaluate_match_the_reference(trained):
    res, rcfg = trained["res"], trained["rcfg"]
    qnet = p_eval.deploy(res, device="cpu")
    rnet = r_models.quantize_net(
        rcfg, np_tree({k: {n: v.numpy() for n, v in node.items()}
                       for k, node in res.model_params().items()}),
        res.deployment_absmax(), plan=trained["rplan"], default_w_bits=4)
    assert_artifacts_equal(qnet, rnet)
    test = p_data.make_dataset("synthetic", split="test", seed=0)
    x, y = next(test.batches(24, 1))
    p_logits = p_models.forward_int(qnet, p_models.quantize_input(qnet, x))
    r_logits = r_models.forward_int(rnet, r_models.quantize_input(rnet, x))
    exact(p_logits, r_logits)
    p_acc = p_eval.evaluate_int(qnet, [(x, y)])
    r_correct = int((np.argmax(np.asarray(r_logits), -1) == y).sum())
    assert p_acc == {"accuracy": r_correct / len(y), "correct": r_correct,
                     "n": len(y)}
    ea = p_eval.edge_agreement(res, qnet, x)
    assert ea["within_1lsb"] >= 0.9 and ea["argmax_agree"] >= 0.9
    fq = p_eval.evaluate_fq(res, [(x, y)])
    assert fq["n"] == p_acc["n"]


def test_fold_check_rejects_float_results_and_a_broken_grid(trained,
                                                            monkeypatch):
    import dataclasses
    res = trained["res"]
    with pytest.raises(ValueError):
        p_eval.fold_check(dataclasses.replace(res, lquant=None))
    real = p_eval.calibrate_weight
    monkeypatch.setattr(p_eval, "calibrate_weight",
                        lambda w, b: real(w * 1.01, b))
    with pytest.raises(AssertionError, match="diverge"):
        p_eval.fold_check(res)


# ------------------------------------------------- task-loss calibration ---

def test_task_loss_calibration_matches_the_reference(trained):
    res, cfg, rcfg = trained["res"], trained["cfg"], trained["rcfg"]
    data = p_data.make_dataset("synthetic", split="train", seed=0)
    xs, ys = zip(*data.batches(16, 2))
    fp = res.model_params()
    pstats, pabs = p_cal.calibrate_vision(cfg, fp, xs,
                                          sensitivity="task_loss",
                                          labels=ys)
    rfp = {k: {n: jnp.asarray(v.numpy()) for n, v in node.items()}
           for k, node in fp.items()}
    rstats, rabs = r_cal.calibrate_vision(rcfg, rfp, list(xs),
                                          sensitivity="task_loss",
                                          labels=list(ys))
    assert set(pabs) == set(rabs)
    for k in rabs:
        np.testing.assert_allclose(pabs[k], rabs[k], rtol=1e-5, err_msg=k)
    for path, rs in rstats.items():
        ps = pstats[path]
        assert (ps.d_in, ps.d_out, ps.sq_ref, ps.taps) == \
            (rs.d_in, rs.d_out, rs.sq_ref, rs.taps)
        np.testing.assert_allclose(ps.a_absmax, rs.a_absmax, rtol=1e-5)
        for b in BITS:
            np.testing.assert_allclose(ps.sq_err[b], rs.sq_err[b],
                                       rtol=SENS_RTOL, atol=SENS_ATOL,
                                       err_msg=f"{path} W{b}")
            np.testing.assert_allclose(ps.col_sq_err[b], rs.col_sq_err[b],
                                       rtol=SENS_RTOL,
                                       atol=SENS_ATOL / ps.d_out,
                                       err_msg=f"{path} W{b} cols")
    # the planner, given the port's stats, makes the reference's plan
    budget = p_plan.auto_budget(pstats, BITS, frac=0.35)
    p = p_plan.plan_mixed_precision(pstats, budget, candidates=BITS,
                                    granularity="channel_group")
    r = r_plan.plan_mixed_precision(
        rstats, r_plan.auto_budget(rstats, BITS, frac=0.35),
        candidates=BITS, granularity="channel_group")
    assert [(x.pattern, x.w_bits, x.segments) for x in p.rules] == \
        [(x.pattern, x.w_bits, x.segments) for x in r.rules]
    with pytest.raises(ValueError):
        p_cal.calibrate_vision(cfg, fp, xs, sensitivity="task_loss")
    with pytest.raises(ValueError):
        p_cal.calibrate_vision(cfg, fp, xs, sensitivity="task_loss",
                               labels=ys[:1])
    with pytest.raises(ValueError):
        p_cal.calibrate_vision(cfg, fp, xs, sensitivity="huh")


# ------------------------------------------------ resume, mesh, the CLI ---

def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A QAT state `repro.ckpt.checkpoint.save` wrote (float32 and int32
    leaves) resumes through `train_qat(from_ckpt=)`; the first resumed
    step's loss is the reference's own resume's."""
    rcfg, pcfg = r_config("qat-cnn", smoke=True), p_config("qat-cnn",
                                                           smoke=True)
    data = r_data.make_dataset("synthetic", seed=0)
    rqc = r_train.QATConfig(steps=6, batch=16, w_bits=4, warmup=2,
                            log_every=1, ckpt_every=6)
    r_train.train_qat(rcfg, data, rqc, ckpt_dir=str(tmp_path))
    assert r_ckpt.latest_step(str(tmp_path)) == 6
    rqc2 = r_train.QATConfig(steps=9, batch=16, w_bits=4, warmup=2,
                             log_every=1)
    pqc2 = p_train.QATConfig(steps=9, batch=16, w_bits=4, warmup=2,
                             log_every=1)
    r_res = r_train.train_qat(rcfg, data, rqc2, from_ckpt=str(tmp_path))
    p_res = p_train.train_qat(pcfg, p_data.make_dataset("synthetic", seed=0),
                              pqc2, from_ckpt=str(tmp_path), device="cpu")
    assert [r["step"] for r in p_res.log] == [6, 7, 8]
    np.testing.assert_allclose(p_res.log[0]["loss"], r_res.log[0]["loss"],
                               rtol=1e-5)
    p_eval.fold_check(p_res)


def test_mesh_training_matches_meshless():
    """A (data=2) mesh of CPU positions: each step's loss and the trained
    weights agree with the meshless run (float sums differ in order)."""
    from repro_torch.launch.mesh import make_cluster_mesh
    cfg = p_config("qat-cnn", smoke=True)
    qc = p_train.QATConfig(steps=4, batch=16, w_bits=4, warmup=1,
                           log_every=1)
    data = p_data.make_dataset("synthetic", seed=0)
    a = p_train.train_qat(cfg, data, qc, device="cpu")
    b = p_train.train_qat(cfg, data, qc, device="cpu",
                          mesh=make_cluster_mesh(2, 1, "cpu"))
    for ra, rb in zip(a.log, b.log):
        np.testing.assert_allclose(rb["loss"], ra["loss"], rtol=1e-5)
    with pytest.raises(NotImplementedError):
        p_train.train_qat(cfg, data, qc, device="cpu",
                          mesh=make_cluster_mesh(1, 2, "cpu"))


@pytest.mark.parametrize("benchmark", [False, True])
def test_train_qat_runs_deterministic_convs(benchmark):
    """The whole loop runs cuDNN's deterministic algorithms without
    autotuning (the card's training reproducible from its seed), and the
    caller's settings come back after it."""
    cudnn = torch.backends.cudnn
    seen = []

    class Recorded:
        def __init__(self):
            self.data = p_data.make_dataset("synthetic", seed=0)

        def batches(self, batch, steps):
            for xy in self.data.batches(batch, steps):
                seen.append((cudnn.deterministic, cudnn.benchmark))
                yield xy

    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = False, benchmark
    try:
        p_train.train_qat(p_config("qat-cnn", smoke=True), Recorded(),
                          p_train.QATConfig(steps=3, batch=4, w_bits=2,
                                            warmup=1, log_every=1),
                          device="cpu")
        after = cudnn.deterministic, cudnn.benchmark
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    assert len(seen) == 4 and set(seen) == {(True, False)}
    assert after == (False, benchmark)


def test_cli_end_to_end_on_the_cpu(tmp_path, mnist_dir):
    out = p_cli.main(["--smoke", "--steps", "6", "--batch", "16",
                      "--device", "cpu", "--calib-batches", "1",
                      "--eval-batches", "1", "--eval-batch", "20",
                      "--ckpt-dir", str(tmp_path / "ck"),
                      "--out", str(tmp_path / "p.json"),
                      "--report", str(tmp_path / "r.json")])
    assert (tmp_path / "p.json").exists() and (tmp_path / "r.json").exists()
    assert [r["deployment"] for r in out["rows"]] == ["uniform_w4",
                                                      "task_loss_plan"]
    out2 = p_cli.main(["--smoke", "--steps", "8", "--batch", "16",
                       "--device", "cpu", "--calib-batches", "1",
                       "--eval-batches", "1", "--eval-batch", "20",
                       "--from-ckpt", str(tmp_path / "ck"), "--mesh", "2",
                       "--dataset", "mnist",
                       "--data-dir", str(mnist_dir),
                       "--out", str(tmp_path / "p2.json"),
                       "--report", str(tmp_path / "r2.json")])
    assert [r["step"] for r in out2["result"].log] == [6, 7]
    out3 = p_cli.main(["--smoke", "--steps", "3", "--batch", "16",
                       "--device", "cpu", "--calib-batches", "1",
                       "--eval-batches", "1", "--eval-batch", "20",
                       "--learned-absmax", "--out", str(tmp_path / "p3.json"),
                       "--report", str(tmp_path / "r3.json")])
    assert p_train.ACT_KEY in out3["result"].params


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = p_config("qat-cnn", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_train.train_qat(cfg, p_data.make_dataset(),
                          p_train.QATConfig(steps=1, batch=4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_cli.main(["--smoke", "--steps", "1"])
