"""Mesh serving in the port against the reference, on the CPU: the
integer CNNs through `forward_int(mesh=)` and `VisionEngine(mesh=)`, the
LM through `Scheduler` / `Engine` (mesh=), the slot manager's and wave
stats' per-device columns, and both CLIs with ``--mesh``.

Port meshes repeat the ``cpu`` device at every position. Vision logits
must equal the reference's meshless forward exactly (its sharded conv
raises `ShardingTypeError` under jax 0.9.0 once ``model`` > 1); its
`VisionEngine` on a (4, 1) data mesh runs, and the port's equals it
there, utilization included. The LM is held against the reference's
meshless `Engine` (its data-mesh scheduler raises under jax 0.9.0):
tokens equal at every step whose reference top-1 margin exceeds 0.1, the
rows within 0.1 (the tolerance of `tests/test_torch_lm_serve.py`), and
the port's mesh tokens identical to its own meshless ones.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.deploy import policy as r_policy
from repro.models import api as r_api
from repro.nn import layers as r_layers
from repro.serve import engine as r_engine
from repro.serve.runtime import scheduler as r_sched
from repro.serve.runtime import slots as r_slots
from repro.vision import models as r_models
from repro.vision.configs import get_vision_config as r_config
from repro_torch import convert
from repro_torch.convert import fp_params_from_numpy
from repro_torch.deploy import policy as p_policy
from repro_torch.launch import convert as p_convert
from repro_torch.launch import serve as p_serve
from repro_torch.launch import vision as p_launch
from repro_torch.models import api as p_api
from repro_torch.nn import layers as p_layers
from repro_torch.parallel import mesh as pm
from repro_torch.serve import engine as p_engine
from repro_torch.serve.runtime import scheduler as p_sched
from repro_torch.serve.runtime import slots as p_slots
from repro_torch.vision import models as p_models
from repro_torch.vision.configs import get_vision_config as p_config

from torch_bridge import assert_same, fp_numpy, jax_tree, np_tree

# every net here has 10 classes: the head takes model = 1 or 2
LAYOUTS = [(2, 2), (4, 1), (1, 2), (3, 1)]
TOL = 0.1


def _mesh(dp, tp):
    return pm.make_mesh((dp, tp), ("data", "model"), "cpu")


def _uniform_ref_plan(cfg, w_bits):
    return r_policy.PrecisionPlan(
        rules=tuple(r_policy.PlanRule(pattern=L.path, w_bits=w_bits)
                    for L in cfg.layers
                    if L.kind in r_models.COMPUTE_KINDS),
        default_w_bits=w_bits)


def _plan_a(policy):
    return policy.PrecisionPlan(rules=(policy.PlanRule(
        pattern="c3", w_bits=8, segments=((0, 128, 8), (128, 256, 4))),))


@functools.lru_cache(maxsize=None)
def _nets(net, plan):
    """(reference net, port net, images) from the same seeded numbers;
    ``plan`` a width, "a" (qat-cnn's c3 split W8 | W4) or "b" (the
    reference's calibrated channel-group plan, loaded by the port)."""
    smoke = net != "qat-cnn"
    rcfg, pcfg = r_config(net, smoke=smoke), p_config(net, smoke=smoke)
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, size=(4, *rcfg.in_hw, rcfg.in_ch)).astype(
        np.float32) for _ in range(2)]
    rfp = r_models.init_fp(rcfg, seed=0)
    absmax = r_models.collect_absmax(rcfg, rfp, batches)
    if plan == "a":
        rplan, pplan = _plan_a(r_policy), _plan_a(p_policy)
    elif plan == "b":
        from repro.deploy import calibrate as r_cal
        from repro.deploy import planner as r_plan
        rstats, absmax = r_cal.calibrate_vision(rcfg, rfp, batches)
        rplan = r_plan.plan_mixed_precision(
            rstats, r_plan.auto_budget(rstats), granularity="channel_group")
        pplan = p_policy.PrecisionPlan.from_json(rplan.to_json())
    else:
        rplan = _uniform_ref_plan(rcfg, plan)
        pplan = p_launch.uniform_plan(pcfg, plan, 8)
    rq = r_models.quantize_net(rcfg, rfp, absmax, plan=rplan)
    pq = p_models.quantize_net(pcfg, fp_params_from_numpy(np_tree(rfp),
                                                          "cpu"),
                               absmax, plan=pplan, device="cpu")
    images = rng.uniform(0, 1, size=(5, *rcfg.in_hw, rcfg.in_ch)).astype(
        np.float32)
    return rq, pq, images


def _same_report(got, want):
    """The wave-utilization columns of two `utilization_report`s."""
    for k in ("devices", "waves", "mean_util", "per_device",
              "occupancy_timeline"):
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), err_msg=k)


NETS = [("resnet8", 8), ("resnet8", 4), ("resnet8", 2),
        ("mobilenet-tiny", 4), ("qat-cnn", "a"), ("qat-cnn", "b")]


@pytest.mark.parametrize("net,plan", NETS, ids=[f"{n}-{p}" for n, p in NETS])
def test_forward_int_on_a_mesh_equals_meshless_reference(net, plan):
    rq, pq, images = _nets(net, plan)
    rx = r_models.quantize_input(rq, images)
    px = p_models.quantize_input(pq, images)
    r_edges, p_edges = {}, {}
    want = r_models.forward_int(
        rq, rx, backend="eager_ref",
        collect=lambda k, v: r_edges.__setitem__(k, v))
    for dp, tp in LAYOUTS:
        got = p_models.forward_int(
            pq, px, mesh=_mesh(dp, tp),
            collect=lambda k, v: p_edges.__setitem__(k, v))
        assert_same(got, want, f"{net} {plan} mesh=({dp},{tp})")
        for k in r_edges:
            assert_same(p_edges[k], r_edges[k], k)
    # the net placed on the mesh once gives the same logits
    mesh = _mesh(2, 2)
    assert_same(p_models.forward_int(p_models.shard_net(pq, mesh), px,
                                     mesh=mesh), want, "shard_net")


def test_per_group_and_ragged_classes_are_refused():
    _, pq, images = _nets("mobilenet-tiny", 8)
    px = p_models.quantize_input(pq, images)
    with pytest.raises(ValueError, match="per_group"):
        p_models.forward_int(pq, px, lowering="per_group",
                             mesh=_mesh(2, 1))
    _, pq, _ = _nets("resnet8", 8)
    with pytest.raises(ValueError, match="N=10 not divisible"):
        p_models.forward_int(pq, px, mesh=_mesh(1, 4))


def test_vision_engine_on_a_data_mesh_equals_reference_engine():
    """The reference's (4, 1) mesh engine runs under jax 0.9.0: logits
    and the whole utilization report equal the port's, batch 3 over 4
    data blocks (one pad slot per wave)."""
    rq, pq, images = _nets("resnet8", 4)
    rmesh = jax.make_mesh((4, 1), ("data", "model"),
                          devices=jax.devices()[:4])
    reng = r_engine.VisionEngine(rq, batch_size=3, mesh=rmesh,
                                 backend="xla")
    peng = p_engine.VisionEngine(pq, batch_size=3, device="cpu",
                                 mesh=_mesh(4, 1))
    assert_same(peng.run(images), reng.run(images), "served logits")
    _same_report(peng.utilization_report(), reng.utilization_report())
    assert peng._dp == reng._dp == 4


@pytest.mark.parametrize("dp,tp,batch", [(2, 2, 4), (2, 2, 3), (4, 1, 5),
                                         (1, 2, 2)])
def test_vision_engine_mesh_logits_and_wave_stats(dp, tp, batch):
    """Logits equal the reference's meshless engine; per-device columns
    equal the reference's `WaveStats` fed the same waves."""
    rq, pq, images = _nets("mobilenet-tiny", 4)
    want = r_engine.VisionEngine(rq, batch_size=batch,
                                 backend="xla").run(images)
    eng = p_engine.VisionEngine(pq, batch_size=batch, device="cpu",
                                mesh=_mesh(dp, tp))
    assert_same(eng.run(images), want, "served logits")
    phys = -(-batch // dp) * dp
    ref = r_sched.WaveStats(batch=phys, dp=dp)
    for w in eng.wave_stats:
        ref._record_wave(w["n_real"])
        ref._finish_wave()
    _same_report(eng.utilization_report(), ref.utilization_report())


def test_slot_manager_and_wave_stats_equal_reference():
    for n, dp in ((3, 4), (5, 2), (8, 4), (4, 1), (7, 3)):
        r, p = r_slots.SlotManager(n, 16, dp=dp), \
            p_slots.SlotManager(n, 16, dp=dp)
        assert (p.block, p.phys, p.real, p.dp, p.free_slots) == (
            r.block, r.phys, r.real, r.dp, r.free_slots)
        rng = np.random.default_rng(n * 10 + dp)
        for step in range(12):
            if p.free_slots and rng.random() < 0.6:
                assert p.admit(step, 4) == r.admit(step, 4)
            elif p.active:
                sid = p.active[int(rng.integers(len(p.active)))].sid
                p.evict(sid)
                r.evict(sid)
            assert p.device_occupancy() == r.device_occupancy()
    for batch, dp, waves in ((4, 2, (4, 3, 1)), (8, 4, (5, 8)),
                             (3, 3, (1, 2, 3))):
        r, p = r_sched.WaveStats(batch, dp), p_sched.WaveStats(batch, dp)
        clock = iter(range(100))
        r.clock = p.clock = lambda: next(clock)
        assert p.utilization_report() == r.utilization_report()
        for n in waves:
            for s in (r, p):
                s._record_wave(n, queue_depth=2)
                s._finish_wave()
        assert p.utilization_report()["per_device"] == pytest.approx(
            r.utilization_report()["per_device"])
        assert p.utilization_report()["mean_util"] == pytest.approx(
            r.utilization_report()["mean_util"])


# ----------------------------------------------------------------- LM ---

@pytest.fixture(scope="module")
def served():
    """qwen smoke W4A8 in both packages from the same numpy weights (the
    recipe of `tests/test_torch_lm_serve.py`)."""
    quant = dict(mode="int", w_bits=4, a_bits=8)
    base = p_api.get_smoke_config("qwen2.5-3b")
    fp = fp_numpy(p_api.build(base).defs())
    fp["embed"]["table"] *= 0.1
    pm_ = p_api.build(dataclasses.replace(
        base, quant=p_layers.QuantConfig(**quant)))
    pp = p_convert.convert_params(pm_.init(0, device="cpu"),
                                  fp_params_from_numpy(fp, "cpu"), 4)
    rm = r_api.build(dataclasses.replace(
        r_api.get_smoke_config("qwen2.5-3b"),
        quant=r_layers.QuantConfig(**quant)))
    return (rm, jax_tree(pp)), (pm_, pp)


def _prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 128, size=int(rng.integers(2, 8))).astype(
        np.int32) for _ in range(n)]


def _run(sched_or_engine, request_cls, prompts, max_new=8):
    """Tokens per request and the logit rows each was sampled from."""
    adapter = sched_or_engine._adapter if hasattr(
        sched_or_engine, "_adapter") else sched_or_engine.adapter
    rows = {}
    consume = adapter.consume

    def record(cur, row):
        rows.setdefault(cur.rid, []).append(np.array(row, np.float32))
        return consume(cur, row)

    adapter.consume = record
    reqs = [request_cls(prompt=p, max_new_tokens=max_new) for p in prompts]
    if hasattr(sched_or_engine, "generate"):
        out = sched_or_engine.generate(reqs)
    else:
        out = sched_or_engine.serve(reqs)
    return ([r.out for r in out],
            [rows[i][len(p) - 1:] for i, p in enumerate(prompts)])


@pytest.mark.parametrize("num_slots", [4, 3])
def test_lm_scheduler_on_a_data_mesh_equals_meshless_reference(served,
                                                               num_slots):
    (rm, rp), (pmodel, pp) = served
    prompts = _prompts()
    want, r_rows = _run(r_engine.Engine(rm, rp, num_slots, 32),
                        r_engine.Request, prompts)
    mesh = _mesh(4, 1)
    adapter = p_engine.Engine(pmodel, pp, num_slots, 32, device="cpu",
                              mesh=mesh)._adapter
    sched = p_sched.Scheduler(adapter, num_slots, policy="wave")
    got, p_rows = _run(sched, p_engine.Request, prompts)
    compared = 0
    for w, g, rr, pr in zip(want, got, r_rows, p_rows):
        assert len(g) == len(w)
        for k, (a, b) in enumerate(zip(w.tolist(), g.tolist())):
            np.testing.assert_allclose(pr[k][:rm.cfg.vocab],
                                       rr[k][:rm.cfg.vocab], atol=TOL)
            top2 = np.sort(rr[k][:rm.cfg.vocab])[-2:]
            if top2[1] - top2[0] <= TOL:
                break
            assert a == b, (k, w, g)
            compared += 1
    assert compared >= len(prompts) * 4
    # the port's meshless engine gives the same tokens, continuous
    # batching on the mesh too
    alone, _ = _run(p_engine.Engine(pmodel, pp, num_slots, 32,
                                    device="cpu"), p_engine.Request,
                    prompts)
    assert [a.tolist() for a in alone] == [g.tolist() for g in got]
    cont = p_sched.Scheduler(adapter, num_slots)
    out, _ = _run(cont, p_engine.Request, prompts)
    assert [a.tolist() for a in out] == [g.tolist() for g in got]
    rep = sched.utilization_report()
    assert rep["devices"] == 4 and len(rep["per_device"]) == 4
    assert sched.slots.phys == 4


def test_lm_mesh_state_is_sharded_and_reset(served):
    """The cache is a tree of `Sharded` leaves split on the batch; the
    recurrent reset clears only the re-admitted slot's rows."""
    from repro_torch.serve.runtime.adapters import LMDecodeAdapter

    _, (pmodel, pp) = served
    mesh = _mesh(2, 1)
    ad = LMDecodeAdapter(pmodel, pp, 16, mesh=mesh)
    state = ad.init_state(4)
    k = state["kv"]["k"]
    assert isinstance(k, pm.Sharded) and k.shape[1] == 4
    assert k.local_shape()[1] == 2 and tuple(k.spec)[1] == "data"
    # one params tree for the two blocks on one device
    assert list(ad._params) == [torch.device("cpu")]
    fake = {"ssm": {"h": pm.device_put(
        torch.ones(2, 4, 3), pm.NamedSharding(mesh, pm.P(None, "data")))}}
    ad.reset_state(fake, np.array([False, False, True, False]))
    got = pm.gather(fake["ssm"]["h"])
    assert got[:, 2].abs().sum() == 0 and got[:, [0, 1, 3]].min() == 1
    # a model axis: each data block's cache placed over its model
    # positions (kv heads), and one step equal to the meshless one
    from repro_torch.parallel import tp
    tp_ad = LMDecodeAdapter(pmodel, pp, 16, mesh=_mesh(2, 2))
    tp_state = tp_ad.init_state(4)
    k = tp_state.blocks[0]["kv"]["k"]
    assert isinstance(k, tp.Split) and k.parts[0].shape[1] == 2
    assert k.parts[0].shape[-2] == pmodel.cfg.kv_heads // 2
    feed = np.array([[3], [5], [7], [9]], np.int32)
    rows, _ = tp_ad.step(tp_state, feed, np.zeros(4, np.int64))
    want, _ = LMDecodeAdapter(pmodel, pp, 16).step(
        pmodel.init_cache(4, 16, device="cpu"), feed, np.zeros(4, np.int64))
    np.testing.assert_array_equal(rows, want)


def test_clis_with_mesh(capsys):
    logits = p_launch.main(["--net", "resnet8", "--smoke", "--device",
                            "cpu", "--mesh", "2,2", "--requests", "5",
                            "--batch", "3"])
    text = capsys.readouterr().out
    assert "mesh: data=2 model=2 (4 positions on cpu x4)" in text
    # batch 3 over 2 blocks of 2 slots: waves of 3 and 2 images
    assert "utilization: mean 0.625 over 2 waves, per-device " \
           "[1.0, 0.25]" in text
    assert "vision deploy done" in text and logits.shape == (5, 10)
    want = p_launch.main(["--net", "resnet8", "--smoke", "--device", "cpu",
                          "--requests", "5", "--batch", "3"])
    capsys.readouterr()
    np.testing.assert_array_equal(logits, want)
    out = p_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--quant",
                        "w4a8", "--device", "cpu", "--requests", "3",
                        "--batch", "3", "--max-new", "3", "--mesh", "2,1"])
    text = capsys.readouterr().out
    assert "mesh: data=2 model=1 (2 positions on cpu x2); waves sharded " \
           "over 'data'" in text
    assert "cluster utilization: 75% over 1 wave(s) [d0=100% d1=50%]" \
        in text
    meshless = p_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--quant",
                             "w4a8", "--device", "cpu", "--requests", "3",
                             "--batch", "3", "--max-new", "3"])
    capsys.readouterr()
    assert [r.out.tolist() for r in out] == [r.out.tolist()
                                             for r in meshless]
    tp_out = p_serve.main(["--arch", "qwen2.5-3b", "--smoke", "--quant",
                           "w4a8", "--device", "cpu", "--requests", "3",
                           "--batch", "3", "--max-new", "3", "--mesh",
                           "1,2"])
    text = capsys.readouterr().out
    assert "mesh: data=1 model=2 (2 positions on cpu x2)" in text
    assert [r.out.tolist() for r in tp_out] == [r.out.tolist()
                                                for r in meshless]


def test_bridged_reference_net_serves_on_a_mesh():
    """The reference's own artifact, carried across as bytes, serves on a
    mesh with the reference's logits."""
    from torch_bridge import neutral

    rq, _, images = _nets("qat-cnn", "a")
    pq = convert.qnet_from_numpy(neutral(rq), "cpu")
    want = r_models.forward_int(rq, r_models.quantize_input(rq, images),
                                backend="eager_ref")
    got = p_engine.VisionEngine(pq, 4, device="cpu",
                                mesh=_mesh(2, 2)).run(images)
    assert_same(got, want, "bridged net on a mesh")
