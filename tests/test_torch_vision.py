"""The port's whole slice against the reference: ResNet-8 and
MobileNetV1-tiny (smoke size) quantized, run and served by both packages
from the same numbers; MobileNet's depthwise layers under both
lowerings.

Integer outputs are compared for exact equality: the quantized artifacts
array by array, every integer edge of `forward_int`, the logits, and
the served results. The one toleranced check is `collect_absmax`, a float
conv forward (XLA vs torch's CPU conv, summed in different orders):
relative tolerance 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.deploy import policy as r_policy
from repro.serve.engine import VisionEngine as RVisionEngine
from repro.vision import layers as r_vl
from repro.vision import models as r_models
from repro.vision.configs import get_vision_config as r_config
from repro_torch import convert
from repro_torch.deploy import policy as p_policy
from repro_torch.launch import vision as p_launch
from repro_torch.serve.engine import VisionEngine as PVisionEngine
from repro_torch.vision import layers as p_vl
from repro_torch.vision import models as p_models
from repro_torch.vision.configs import get_vision_config as p_config

from torch_bridge import (assert_artifacts_equal, assert_same, neutral,
                          np_tree)

SEED = 0
WIDTHS = [8, 4, 2]


def _uniform_ref_plan(cfg, w_bits):
    return r_policy.PrecisionPlan(
        rules=tuple(r_policy.PlanRule(pattern=L.path, w_bits=w_bits)
                    for L in cfg.layers if L.kind in r_models.COMPUTE_KINDS),
        default_w_bits=w_bits)


def _art(net):
    """Reference fp params, calibration images, absmax and images."""
    rcfg = r_config(net, smoke=True)
    pcfg = p_config(net, smoke=True)
    rng = np.random.default_rng(SEED)
    batches = [rng.uniform(0, 1, size=(4, *rcfg.in_hw, 3)).astype(
        np.float32) for _ in range(2)]
    rfp = r_models.init_fp(rcfg, seed=SEED)
    absmax = r_models.collect_absmax(rcfg, rfp, batches)
    images = rng.uniform(0, 1, size=(6, *rcfg.in_hw, 3)).astype(np.float32)
    return dict(rcfg=rcfg, pcfg=pcfg, rfp=rfp, fp_np=np_tree(rfp),
                batches=batches, absmax=absmax, images=images, nets={})


@pytest.fixture(scope="module")
def art():
    return _art("resnet8")


@pytest.fixture(scope="module")
def mart():
    return _art("mobilenet-tiny")


def _nets(art, w_bits):
    """(reference net, port net) at uniform ``w_bits`` (cached)."""
    if w_bits not in art["nets"]:
        rq = r_models.quantize_net(art["rcfg"], art["rfp"], art["absmax"],
                                   plan=_uniform_ref_plan(art["rcfg"],
                                                          w_bits))
        pq = p_models.quantize_net(
            art["pcfg"], convert.fp_params_from_numpy(art["fp_np"], "cpu"),
            art["absmax"], plan=p_launch.uniform_plan(art["pcfg"], w_bits, 8),
            device="cpu")
        art["nets"][w_bits] = (rq, pq)
    return art["nets"][w_bits]


def test_init_fp_and_trace_shapes_match(art):
    _check_init_fp_and_trace_shapes(art, 9 * 3 + 1)   # 9 convs + head


def test_mobilenet_init_fp_and_trace_shapes_match(mart):
    # stem, two dw + pw blocks (smoke), head, drawn in the reference's
    # order: a skipped or reordered draw would shift every later array
    _check_init_fp_and_trace_shapes(mart, 5 * 3 + 1)


def _check_init_fp_and_trace_shapes(art, n_arrays):
    pfp = p_models.init_fp(art["pcfg"], seed=SEED, device="cpu")
    flat_r, flat_p = [], []

    def walk(t, out):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], out)
        else:
            out.append(t)
    walk(art["fp_np"], flat_r)
    walk(pfp, flat_p)
    assert len(flat_r) == len(flat_p) == n_arrays
    for p, r in zip(flat_p, flat_r):
        assert_same(p, r, "fp param")
    rs = [(t["in"], t["out"]) for t in r_models.trace_shapes(art["rcfg"])]
    ps = [(t["in"], t["out"]) for t in p_models.trace_shapes(art["pcfg"])]
    assert rs == ps


def test_collect_absmax_agrees_to_stated_tolerance(art):
    _check_collect_absmax(art)


def test_mobilenet_collect_absmax_agrees_to_stated_tolerance(mart):
    _check_collect_absmax(mart)


def _check_collect_absmax(art):
    pfp = convert.fp_params_from_numpy(art["fp_np"], "cpu")
    got = p_models.collect_absmax(art["pcfg"], pfp, art["batches"])
    assert got.keys() == art["absmax"].keys()
    for k, v in art["absmax"].items():
        assert got[k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("w_bits", WIDTHS)
def test_quantize_net_artifacts_byte_identical(art, w_bits):
    _check_artifacts(art, w_bits)


@pytest.mark.parametrize("w_bits", WIDTHS)
def test_mobilenet_quantize_net_artifacts_byte_identical(mart, w_bits):
    _check_artifacts(mart, w_bits)
    _, pq = _nets(mart, w_bits)
    dws = [q for L, q in pq.qlayers if L.kind == "dwconv"]
    assert len(dws) == 2 and all(isinstance(q, p_vl.QDepthwiseConv2D)
                                 for q in dws)


def _check_artifacts(art, w_bits):
    rq, pq = _nets(art, w_bits)
    assert_artifacts_equal(pq.qlayers, rq.qlayers, "qlayers")
    assert_artifacts_equal(pq.input_spec, rq.input_spec, "input_spec")
    assert pq.eps_logits == rq.eps_logits
    assert pq.layer_bits() == rq.layer_bits()
    assert (p_models.streamed_weight_bytes(pq)
            == r_models.streamed_weight_bytes(rq))
    assert (p_models.vision_artifact_bytes(pq)
            == r_models.vision_artifact_bytes(rq))


@pytest.mark.parametrize("w_bits", WIDTHS)
def test_forward_int_logits_and_edges_identical(art, w_bits):
    _check_forward_int(art, w_bits, "auto")


@pytest.mark.parametrize("lowering", ["qdot", "per_group"])
@pytest.mark.parametrize("w_bits", WIDTHS)
def test_mobilenet_forward_int_identical_under_both_lowerings(mart, w_bits,
                                                              lowering):
    _check_forward_int(mart, w_bits, lowering)


def _check_forward_int(art, w_bits, lowering):
    rq, pq = _nets(art, w_bits)
    rx = r_models.quantize_input(rq, art["images"])
    px = p_models.quantize_input(pq, art["images"])
    assert_same(px, rx, "input codes")
    r_edges, p_edges = {}, {}
    rl = r_models.forward_int(rq, rx, backend="xla",
                              collect=lambda k, v: r_edges.setdefault(k, v))
    pl = p_models.forward_int(pq, px, lowering=lowering,
                              collect=lambda k, v: p_edges.setdefault(k, v))
    assert list(p_edges) == list(r_edges)
    for k in r_edges:
        assert_same(p_edges[k], r_edges[k], k)
    assert_same(pl, rl, "logits")
    # the reference's own artifact, carried across without re-quantizing
    bridged = convert.qnet_from_numpy(neutral(rq), "cpu")
    assert_same(p_models.forward_int(bridged, px, lowering=lowering), rl,
                "bridged logits")


def test_vision_engine_ragged_waves_match_reference(art):
    rq, pq = _nets(art, 4)
    want = RVisionEngine(rq, batch_size=4, backend="xla").run(art["images"])
    eng = PVisionEngine(pq, batch_size=4, device="cpu")
    got = eng.run(art["images"])
    assert_same(got, want, "served logits")
    rep = eng.utilization_report()
    assert rep["waves"] == 2 and rep["mean_util"] == pytest.approx(0.75)
    assert eng.serving_report()["requests"] == 6
    assert eng.run(np.zeros((0, 16, 16, 3))).shape == (0, 10)


def test_plan_saved_by_reference_loads_and_quantizes_alike(art, tmp_path):
    rules = (
        r_policy.PlanRule(pattern="stem", w_bits=8),
        r_policy.PlanRule(pattern="s3/*", w_bits=2,
                          pipeline="double_buffer"),
        r_policy.PlanRule(pattern="head", w_bits=4, a_absmax=1.5),
        r_policy.PlanRule(pattern="s9/*", w_bits=8,
                          segments=((0, 128, 4), (128, 200, 8))),
    )
    rplan = r_policy.PrecisionPlan(rules=rules, default_w_bits=4,
                                   meta={"budget": 1.0})
    path = tmp_path / "plan.json"
    r_policy.save_plan(rplan, path)
    pplan = p_policy.load_plan(path)
    assert len(pplan.rules) == len(rules)
    for p, r in zip(pplan.rules, rules):
        assert (p.pattern, p.w_bits, p.a_bits, p.backend, p.a_absmax,
                p.pipeline, p.segments) == (r.pattern, r.w_bits, r.a_bits,
                                            r.backend, r.a_absmax,
                                            r.pipeline, r.segments)
    assert pplan.to_json() == rplan.to_json()
    assert pplan.distinct_w_bits() == rplan.distinct_w_bits()
    # a mixed-width plan quantizes to the same artifacts
    rq = r_models.quantize_net(art["rcfg"], art["rfp"], art["absmax"],
                               plan=rplan)
    pq = p_models.quantize_net(
        art["pcfg"], convert.fp_params_from_numpy(art["fp_np"], "cpu"),
        art["absmax"], plan=pplan, device="cpu")
    assert_artifacts_equal(pq.qlayers, rq.qlayers, "mixed plan")
    assert pq.layer_bits()["s3/c1"] == 2
    rx = r_models.quantize_input(rq, art["images"][:2])
    assert_same(p_models.forward_int(pq, p_models.quantize_input(
        pq, art["images"][:2])), r_models.forward_int(rq, rx, backend="xla"),
        "mixed-plan logits")


def test_plan_with_reference_backend_is_refused(tmp_path):
    path = tmp_path / "plan.json"
    r_policy.save_plan(r_policy.PrecisionPlan(rules=(
        r_policy.PlanRule(pattern="stem", w_bits=8, backend="xla"),)), path)
    with pytest.raises(ValueError, match="'cuda', 'torch'"):
        p_policy.load_plan(path)
    rule = p_policy.PlanRule(pattern="stem", w_bits=8, backend=None)
    assert rule.backend is None
    with pytest.raises(ValueError, match="widest"):
        p_policy.PlanRule(pattern="x", w_bits=4, segments=((0, 128, 8),))


@pytest.mark.parametrize("window", [0, 2])
def test_avgpool_matches_reference(window, rng):
    x = rng.integers(0, 128, size=(3, 6, 6, 5)).astype(np.int8)
    m, d = r_vl.fold_avgpool_requant(36 if window == 0 else 4, 0.02, 0.019)
    assert (m, d) == p_vl.fold_avgpool_requant(36 if window == 0 else 4,
                                               0.02, 0.019)
    for ob in (8, 4, 2):
        r = r_vl.QAvgPool2D(window=window, stride=2, m=m, d=d, out_bits=ob)
        p = p_vl.QAvgPool2D(window=window, stride=2, m=m, d=d, out_bits=ob)
        assert_same(p.apply(torch.from_numpy(x)), r.apply(jnp.asarray(x)),
                    f"avgpool out_bits={ob}")


def test_residual_add_and_maxpool_match_reference(rng):
    a = rng.integers(0, 128, size=(2, 5, 5, 4)).astype(np.int8)
    b = rng.integers(0, 16, size=(2, 5, 5, 4)).astype(np.int8)
    fold = r_vl.fold_add_requant(0.03, 0.2, 0.04)
    assert fold == p_vl.fold_add_requant(0.03, 0.2, 0.04)
    for ob in (8, 4, 2):
        r = r_vl.QResidualAdd(*fold, out_bits=ob)
        p = p_vl.QResidualAdd(*fold, out_bits=ob)
        assert_same(p.apply(torch.from_numpy(a), torch.from_numpy(b)),
                    r.apply(jnp.asarray(a), jnp.asarray(b)), f"add {ob}")
    assert_same(p_vl.QMaxPool2D(2, 2).apply(torch.from_numpy(a)),
                r_vl.QMaxPool2D(2, 2).apply(jnp.asarray(a)), "maxpool")
    xf = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    assert_same(p_vl.maxpool_fp(torch.from_numpy(xf), 2, 2),
                r_vl.maxpool_fp(jnp.asarray(xf), 2, 2), "maxpool fp")


def test_cli_serves_on_cpu_and_names_what_waits(art, capsys, tmp_path):
    logits = p_launch.main(["--net", "resnet8", "--smoke", "--device", "cpu",
                            "--bits", "2", "--requests", "3", "--batch",
                            "2"])
    assert logits.shape == (3, 10) and logits.dtype == np.int32
    assert "vision deploy done" in capsys.readouterr().out
    # several widths run the calibrator and the planner
    p_launch.main(["--net", "resnet8", "--smoke", "--device", "cpu",
                   "--bits", "8,4", "--out", str(tmp_path / "plan.json"),
                   "--requests", "2", "--batch", "2"])
    assert "vision deploy done" in capsys.readouterr().out
    assert p_config("qat-cnn").name == "qat-cnn"
    # the paper's third network builds and serves too
    logits = p_launch.main(["--net", "mobilenet-tiny", "--smoke", "--device",
                            "cpu", "--bits", "4", "--requests", "3",
                            "--batch", "2"])
    assert logits.shape == (3, 10) and logits.dtype == np.int32
    out = capsys.readouterr().out
    assert "vision deploy done" in out and "'block0/dw': 4" in out
    with pytest.raises(KeyError):
        p_config("vgg")


def test_segmented_plan_and_missing_absmax_raise(art):
    # a run map must tile the conv's channels (the smoke stem has 8), and
    # the head takes no segments (as in the reference)
    pfp = convert.fp_params_from_numpy(art["fp_np"], "cpu")
    for rule, err, match in (
            (p_policy.PlanRule(pattern="stem", w_bits=8,
                               segments=((0, 4, 8),)), ValueError,
             "do not tile"),
            (p_policy.PlanRule(pattern="head", w_bits=8,
                               segments=((0, 10, 8),)), NotImplementedError,
             "segmented")):
        with pytest.raises(err, match=match):
            p_models.quantize_net(art["pcfg"], pfp, art["absmax"],
                                  plan=p_policy.PrecisionPlan(rules=(rule,)),
                                  device="cpu")
    absmax = dict(art["absmax"])
    del absmax["s2/c1"]
    with pytest.raises(KeyError, match="s2/c1"):
        p_models.quantize_net(art["pcfg"], pfp, absmax, device="cpu")


def test_to_device_copies_every_tensor(art):
    _, pq = _nets(art, 8)
    moved = convert.to_device(pq, "cpu")
    assert moved is not pq and dataclasses.is_dataclass(moved)
    assert_artifacts_equal(moved.qlayers, pq.qlayers, "to_device")


def test_obs_gate_records_serving_counters_only_when_on(art):
    from repro_torch.obs import trace as obs
    _, pq = _nets(art, 2)
    was = obs.enabled()
    obs.disable()
    obs.reset()
    try:
        PVisionEngine(pq, batch_size=4, device="cpu").run(art["images"][:5])
        assert obs.counter_values() == {} and obs.spans() == []
        obs.enable()
        PVisionEngine(pq, batch_size=4, device="cpu").run(art["images"][:5])
        c = obs.counter_values()
        assert c["serve.admits"] == 5 and c["engine.waves"] == 2
        assert c["engine.requests"] == 5
        assert len(obs.spans("serve.step")) == 2
    finally:
        obs.reset()
        (obs.enable if was else obs.disable)()


def test_scheduler_policies_agree_and_queue_is_bounded(art):
    from repro_torch.serve.runtime.adapters import VisionAdapter
    from repro_torch.serve.runtime.scheduler import Backpressure, Scheduler
    _, pq = _nets(art, 8)
    wave = Scheduler(VisionAdapter(pq), 4, policy="wave")
    cont = Scheduler(VisionAdapter(pq), 4, policy="continuous")
    got_w = np.stack(wave.serve(list(art["images"])))
    got_c = np.stack(cont.serve(list(art["images"])))
    np.testing.assert_array_equal(got_w, got_c)
    # virtual clock: one step per time unit, latency in those units
    sched = Scheduler(VisionAdapter(pq), 2, policy="continuous",
                      max_queue=2)
    for t, img in enumerate(art["images"][:2]):
        sched.submit(img, now=float(t))
    with pytest.raises(Backpressure):
        sched.submit(art["images"][2], now=2.0)
    assert sorted(sched.step(now=5.0)) == [0, 1] and sched.idle
    assert sched.serving_report()["latency"]["max"] == 5.0
    with pytest.raises(ValueError, match="policy"):
        Scheduler(VisionAdapter(pq), 2, policy="fifo")
