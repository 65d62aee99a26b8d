"""The port's deploy flow (calibrate -> plan -> pack -> serve) against the
reference, on the CPU.

Tolerances: `calibrate_vision`'s error sums (sq_err, sq_ref, col_sq_err)
are float32 reductions over float convs, which XLA and torch's CPU conv
order differently, so they agree within rtol 1e-3; the absmax values are
maxima of single conv outputs and agree within rtol 1e-5. Everything
downstream of the stats is exact: given the reference's own stats, the
planner returns byte-identical plan JSON, and a plan quantizes to
byte-identical artifacts and identical logits.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.deploy import calibrate as r_cal
from repro.deploy import planner as r_plan
from repro.deploy import policy as r_policy
from repro.vision import models as r_models
from repro.vision.configs import get_vision_config as r_config
from repro_torch import convert
from repro_torch.deploy import calibrate as p_cal
from repro_torch.deploy import planner as p_plan
from repro_torch.deploy import policy as p_policy
from repro_torch.launch import vision as p_launch
from repro_torch.vision import models as p_models
from repro_torch.vision.configs import get_vision_config as p_config

from torch_bridge import assert_artifacts_equal, assert_same, np_tree

STATS_RTOL = 1e-3     # float32 error sums: XLA vs torch conv order
ABSMAX_RTOL = 1e-5    # maxima of one float conv output


@pytest.fixture(scope="module")
def calib():
    """qat-cnn at full width calibrated by both packages on the same
    seeded fp params and images."""
    rcfg, pcfg = r_config("qat-cnn"), p_config("qat-cnn")
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, size=(4, 16, 16, 1)).astype(np.float32)
               for _ in range(2)]
    rfp = r_models.init_fp(rcfg, seed=0)
    rstats, rabsmax = r_cal.calibrate_vision(rcfg, rfp, batches)
    pfp = convert.fp_params_from_numpy(np_tree(rfp), "cpu")
    pstats, pabsmax = p_cal.calibrate_vision(pcfg, pfp, batches)
    images = rng.uniform(0, 1, size=(6, 16, 16, 1)).astype(np.float32)
    return dict(rcfg=rcfg, pcfg=pcfg, rfp=rfp, pfp=pfp, rstats=rstats,
                rabsmax=rabsmax, pstats=pstats, pabsmax=pabsmax,
                images=images)


def _port_stats(rstats):
    """The reference's CalibStats as the port's, numbers as they are."""
    return {p: p_cal.CalibStats(**{
        f.name: getattr(st, f.name) for f in dataclasses.fields(st)})
        for p, st in rstats.items()}


@pytest.fixture(scope="module")
def mcalib():
    """mobilenet-tiny (smoke) calibrated by both packages on the same
    seeded fp params and images."""
    rcfg = r_config("mobilenet-tiny", smoke=True)
    pcfg = p_config("mobilenet-tiny", smoke=True)
    rng = np.random.default_rng(1)
    batches = [rng.uniform(0, 1, size=(4, 16, 16, 3)).astype(np.float32)
               for _ in range(2)]
    rfp = r_models.init_fp(rcfg, seed=1)
    rstats, rabsmax = r_cal.calibrate_vision(rcfg, rfp, batches)
    pfp = convert.fp_params_from_numpy(np_tree(rfp), "cpu")
    pstats, pabsmax = p_cal.calibrate_vision(pcfg, pfp, batches)
    images = rng.uniform(0, 1, size=(3, 16, 16, 3)).astype(np.float32)
    return dict(rcfg=rcfg, pcfg=pcfg, rfp=rfp, pfp=pfp, rstats=rstats,
                rabsmax=rabsmax, pstats=pstats, pabsmax=pabsmax,
                images=images)


def test_calibrate_vision_matches_reference(calib):
    _check_calibration(calib, ["c1", "c2", "c3", "head"])


def test_mobilenet_calibrate_vision_matches_reference(mcalib):
    _check_calibration(mcalib, ["stem", "block0/dw", "block0/pw",
                                "block1/dw", "block1/pw", "head"])
    # a depthwise layer is priced as its block-diagonal GEMM (fh*fw*C, C)
    for path, c in (("block0/dw", 8), ("block1/dw", 16)):
        st = mcalib["pstats"][path]
        assert (st.d_in, st.d_out) == (9 * c, c), path
        assert st.col_sq_err[8].shape == (c,)


def _check_calibration(calib, paths):
    rs, ps = calib["rstats"], calib["pstats"]
    assert list(ps) == list(rs) == paths
    for path, r in rs.items():
        p = ps[path]
        assert (p.layers, p.d_in, p.d_out, p.taps) == \
            (r.layers, r.d_in, r.d_out, r.taps), path
        assert p.a_absmax == pytest.approx(r.a_absmax, rel=ABSMAX_RTOL)
        assert p.sq_ref == pytest.approx(r.sq_ref, rel=STATS_RTOL), path
        assert sorted(p.sq_err) == sorted(r.sq_err) == [2, 4, 8]
        for b in (8, 4, 2):
            assert p.sq_err[b] == pytest.approx(r.sq_err[b],
                                                rel=STATS_RTOL), (path, b)
            np.testing.assert_allclose(p.col_sq_err[b], r.col_sq_err[b],
                                       rtol=STATS_RTOL,
                                       err_msg=f"{path} W{b}")
            assert p.sens(b) == pytest.approx(r.sens(b), rel=STATS_RTOL)
    assert calib["pabsmax"].keys() == calib["rabsmax"].keys()
    for k, v in calib["rabsmax"].items():
        assert calib["pabsmax"][k] == pytest.approx(v, rel=ABSMAX_RTOL), k


def test_calibrate_vision_refuses_task_loss(calib):
    """task_loss is ported (tests/test_torch_qat.py holds it against the
    reference); without labels, or with a label batch short, it refuses as
    the reference does."""
    with pytest.raises(ValueError, match="labels"):
        p_cal.calibrate_vision(calib["pcfg"], calib["pfp"], [],
                               sensitivity="task_loss")
    with pytest.raises(ValueError, match="label batches"):
        p_cal.calibrate_vision(calib["pcfg"], calib["pfp"],
                               [calib["images"]], sensitivity="task_loss",
                               labels=[])
    with pytest.raises(ValueError, match="sensitivity"):
        p_cal.calibrate_vision(calib["pcfg"], calib["pfp"], [],
                               sensitivity="hessian")


@pytest.mark.parametrize("granularity", ["layer", "channel_group"])
@pytest.mark.parametrize("frac", [0.0, 0.05, 0.3, 0.5, 1.0])
def test_planner_json_identical_given_reference_stats(calib, granularity,
                                                      frac):
    rstats, pstats = calib["rstats"], _port_stats(calib["rstats"])
    rb = r_plan.auto_budget(rstats, frac=frac)
    assert p_plan.auto_budget(pstats, frac=frac) == rb
    meta = {"arch": "qat-cnn", "smoke": False}
    want = r_plan.plan_mixed_precision(rstats, rb, granularity=granularity,
                                       meta=meta)
    got = p_plan.plan_mixed_precision(pstats, rb, granularity=granularity,
                                      meta=meta)
    assert got.to_json() == want.to_json()
    assert got.rules == p_policy.PrecisionPlan.from_json(
        want.to_json()).rules
    if granularity == "channel_group":
        coarse = p_plan.plan_mixed_precision(pstats, rb)
        assert (got.meta["packed_weight_bytes"]
                <= coarse.meta["packed_weight_bytes"])


@pytest.mark.parametrize("granularity", ["layer", "channel_group"])
@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_mobilenet_plan_json_identical_and_serves_alike(mcalib, granularity,
                                                        frac):
    """Every MobileNet layer has C <= CHUNK, so a channel-group plan gives
    no segments (a depthwise layer refuses them); given the reference's
    stats the plan JSON is the reference's, and it quantizes to
    byte-identical artifacts whose logits agree under both lowerings."""
    rstats, pstats = mcalib["rstats"], _port_stats(mcalib["rstats"])
    rb = r_plan.auto_budget(rstats, frac=frac)
    meta = {"arch": "mobilenet-tiny", "smoke": True}
    want = r_plan.plan_mixed_precision(rstats, rb, granularity=granularity,
                                       meta=meta)
    got = p_plan.plan_mixed_precision(pstats, rb, granularity=granularity,
                                      meta=meta)
    assert got.to_json() == want.to_json()
    assert all(r.segments is None for r in got.rules)
    rq = r_models.quantize_net(mcalib["rcfg"], mcalib["rfp"],
                               mcalib["rabsmax"], plan=want)
    pq = p_models.quantize_net(mcalib["pcfg"], mcalib["pfp"],
                               mcalib["rabsmax"], plan=got, device="cpu")
    assert_artifacts_equal(pq.qlayers, rq.qlayers, "mobilenet plan")
    assert pq.layer_bits() == rq.layer_bits()
    assert (p_models.streamed_weight_bytes(pq)
            == r_models.streamed_weight_bytes(rq))
    rl = r_models.forward_int(rq, r_models.quantize_input(
        rq, mcalib["images"]), backend="xla")
    px = p_models.quantize_input(pq, mcalib["images"])
    for lowering in ("qdot", "per_group"):
        assert_same(p_models.forward_int(pq, px, lowering=lowering), rl,
                    f"plan logits ({lowering})")


def test_depthwise_layer_refuses_segments(mcalib):
    plan = p_policy.PrecisionPlan(rules=(p_policy.PlanRule(
        pattern="block0/dw", w_bits=8, segments=((0, 8, 8),)),))
    with pytest.raises(NotImplementedError, match="depthwise"):
        p_models.quantize_net(mcalib["pcfg"], mcalib["pfp"],
                              mcalib["rabsmax"], plan=plan, device="cpu")


def _skewed_stats(cal):
    """Path a's first channel group is hot, the rest nearly free; path b
    is uniformly cheap (the reference suite's fine-grain case)."""
    def stats_for(path, d_out, hot):
        col = {}
        for b, tot in {8: 1e-8, 4: 1e-4, 2: 1e-2}.items():
            cols = np.full((d_out,), tot / d_out, np.float64)
            if hot and b < 8:
                cols[:128] = 10.0 / 128
            col[b] = cols
        return cal.CalibStats(path, layers=2, d_in=256, d_out=d_out,
                              a_absmax=3.0,
                              sq_err={b: float(c.sum())
                                      for b, c in col.items()},
                              sq_ref=1.0, taps=1, col_sq_err=col)
    a = stats_for("layers/mlp/wi", 3 * 128, True)
    b = stats_for("layers/attn/wq", 2 * 128, False)
    return {a.path: a, b.path: b}


def test_fine_plan_is_never_worse_and_wins_on_skewed_stats():
    rstats, pstats = _skewed_stats(r_cal), _skewed_stats(p_cal)
    base = sum(st.sens(8) for st in pstats.values())
    full = sum(st.sens(2) for st in pstats.values())
    for frac in (0.0, 0.001, 0.01, 0.1, 0.5, 1.0):
        budget = base + frac * (full - base)
        coarse = p_plan.plan_mixed_precision(pstats, budget)
        fine = p_plan.plan_mixed_precision(pstats, budget,
                                           granularity="channel_group")
        assert (fine.meta["packed_weight_bytes"]
                <= coarse.meta["packed_weight_bytes"]), frac
        assert fine.to_json() == r_plan.plan_mixed_precision(
            rstats, budget, granularity="channel_group").to_json()
    budget = base + 0.05
    fine = p_plan.plan_mixed_precision(pstats, budget,
                                       granularity="channel_group")
    coarse = p_plan.plan_mixed_precision(pstats, budget)
    assert (fine.meta["packed_weight_bytes"]
            < coarse.meta["packed_weight_bytes"])
    wi = {r.pattern: r for r in fine.rules}["layers/mlp/wi"]
    assert wi.segments[0][2] == 8 and len(wi.segments) >= 2
    for runs in ([(0, 384, 4)], [(0, 128, 8), (128, 384, 2)]):
        assert p_plan.segmented_path_bytes(2, 256, 384, runs) == \
            r_plan.segmented_path_bytes(2, 256, 384, runs)
    assert p_plan.packed_weight_bytes(2, 200, 384, 4) == \
        r_plan.packed_weight_bytes(2, 200, 384, 4)
    with pytest.raises(ValueError, match="CHUNK"):
        p_plan.plan_mixed_precision(pstats, 1.0, group_size=100,
                                    granularity="channel_group")
    with pytest.raises(ValueError, match="granularity"):
        p_plan.plan_mixed_precision(pstats, 1.0, granularity="column")


def test_channel_group_plan_serves_identical_logits(calib, tmp_path):
    """Plan (b): the reference's calibrate + channel-group plan, saved as
    JSON, loaded by the port and quantized with the same absmax, gives
    byte-identical artifacts and identical logits."""
    rstats = calib["rstats"]
    rp = r_plan.plan_mixed_precision(rstats, r_plan.auto_budget(rstats),
                                     granularity="channel_group")
    path = tmp_path / "plan_b.json"
    r_policy.save_plan(rp, path)
    pp = p_policy.load_plan(path)
    rq = r_models.quantize_net(calib["rcfg"], calib["rfp"],
                               calib["rabsmax"], plan=rp)
    pq = p_models.quantize_net(calib["pcfg"], calib["pfp"],
                               calib["rabsmax"], plan=pp, device="cpu")
    assert_artifacts_equal(pq.qlayers, rq.qlayers, "plan (b)")
    rx = r_models.quantize_input(rq, calib["images"])
    assert_same(p_models.forward_int(pq, p_models.quantize_input(
        pq, calib["images"])), r_models.forward_int(rq, rx, backend="xla"),
        "plan (b) logits")


def test_cli_calibrates_plans_and_serves(tmp_path, capsys):
    out = tmp_path / "vplan.json"
    logits = p_launch.main(["--net", "qat-cnn", "--smoke", "--device",
                            "cpu", "--bits", "8,4,2", "--out", str(out),
                            "--requests", "3", "--batch", "2"])
    text = capsys.readouterr().out
    assert "vision deploy done" in text and "calibrating" in text
    assert logits.shape == (3, 10)
    plan = p_policy.load_plan(out)
    assert sorted(r.pattern for r in plan.rules) == \
        ["c1", "c2", "c3", "head"]
    assert json.loads(out.read_text())["meta"]["arch"] == "qat-cnn-smoke"
    # the saved plan serves the same logits through --from-plan
    again = p_launch.main(["--net", "qat-cnn", "--smoke", "--device", "cpu",
                           "--from-plan", str(out), "--requests", "3",
                           "--batch", "2"])
    np.testing.assert_array_equal(again, logits)
    with pytest.raises(ValueError, match="does not run on cpu"):
        p_launch.main(["--net", "qat-cnn", "--smoke", "--device", "cpu",
                       "--backend", "cuda"])
