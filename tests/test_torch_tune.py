"""The port's measured launch cache (`repro_torch.kernels.tune`) case for
case against the reference's suite (`tests/test_tune_cache.py`), on the
CPU.

Entries carry {launch, pipeline, us, timer}:
* entry round trip through save / clear / load / merge; unknown
  pipelines and timers refused;
* sweep -> persist -> reload: `autotune_qdot` / `autotune_qconv` on the
  CPU record ``launch: null``, 'off' and ``"timer": "wall"``, and the
  api consumes the reloaded entries (a dispatch-log cache hit);
* a stale port artifact and a reference (version 3, TPU blocks) artifact
  fail `load` loudly; the env preload downgrades to a RuntimeWarning;
* merge conflicts: the incoming entry wins;
* ``REPRO_QTUNE_CACHE`` missing / stale / valid;
* a cache never changes a result: with a tuned pipeline, a cached
  ``launch: null`` entry or a cached launch (which the CPU ignores), the
  CPU outputs are identical to the untuned ones;
* `gemm_launches` lists every launch `gemm_launch_plan` accepts, the
  planned one first.
"""
import json
import warnings

import pytest
import torch

from repro.kernels import tune as r_tune
from repro_torch.kernels import api, tune
from repro_torch.kernels.qmatmul import kernel as gk
from repro_torch.obs import trace as obs

LAUNCH = {"splits": 2, "min_blocks": 1}


@pytest.fixture(autouse=True)
def _clean_cache():
    tune.clear()
    r_tune.clear()
    obs.disable()
    obs.reset()
    yield
    tune.clear()
    r_tune.clear()
    obs.disable()
    obs.reset()


def test_entry_roundtrip_carries_launch_pipeline_us_timer(tmp_path):
    tune.record("qdot", (64, 256, 256), 4, 4, "cuda", LAUNCH,
                pipeline="double_buffer", us=12.5, timer="device")
    tune.record("qconv", (1, 8, 8, 16, 3, 3, 1, 1, 32, 1), 8, 8, "torch",
                us=99.0, timer="wall")
    f = tmp_path / "tune.json"
    tune.save(f)
    tune.clear()
    assert tune.get_entry("qdot", (64, 256, 256), 4, 4, "cuda") is None
    tune.merge(tune.load(f))
    e = tune.get_entry("qdot", (64, 256, 256), 4, 4, "cuda")
    assert e == {"launch": LAUNCH, "pipeline": "double_buffer", "us": 12.5,
                 "timer": "device"}
    assert tune.get_pipeline("qdot", (64, 256, 256), 4, 4,
                             "cuda") == "double_buffer"
    # the backend is part of the key
    assert tune.get_entry("qdot", (64, 256, 256), 4, 4, "torch") is None
    assert tune.get_entry("qconv", (1, 8, 8, 16, 3, 3, 1, 1, 32, 1), 8, 8,
                          "torch")["launch"] is None
    d = json.loads(f.read_text())
    assert d["version"] == tune.CACHE_VERSION != r_tune.CACHE_VERSION
    assert set(d["entries"]["qdot|64x256x256|a4w4|cuda"]) == {
        "launch", "pipeline", "us", "timer"}
    # entries hand out copies
    e["launch"]["splits"] = 7
    assert tune.entries()["qdot|64x256x256|a4w4|cuda"]["launch"] == LAUNCH


def test_record_rejects_unknown_pipeline_and_timer():
    with pytest.raises(ValueError, match="unknown pipeline mode"):
        tune.record("qdot", (8, 128, 128), 8, 8, "torch", pipeline="bogus")
    with pytest.raises(ValueError, match="unknown timer"):
        tune.record("qdot", (8, 128, 128), 8, 8, "torch", timer="cycles")


def test_sweep_persist_reload_roundtrip(tmp_path):
    """Measured sweep on the CPU -> JSON artifact -> fresh state -> the
    api resolves the reloaded entries and its outputs do not move."""
    gen = torch.Generator().manual_seed(0)
    params, xp = tune._mk_qdot_artifact(gen, 32, 200, 48, 4, 2)
    cparams, x = tune._mk_qconv_artifact(gen, 8, 8, 16, 24, 3, 3, 1, 1, 8,
                                         4, batch=2)
    want_q = api.qdot_packed(params, xp)
    want_c = api.qconv(cparams, x)
    with obs.enabled_scope():
        assert tune.autotune_qdot(params, xp, iters=1) == (None, "off")
        assert tune.autotune_qconv(cparams, x, iters=1) == (None, "off")
        sweeps = obs.spans("tune.sweep", cat="tune")
    assert [s["args"]["op"] for s in sweeps] == ["qdot", "qconv"]
    for s in sweeps:
        a = s["args"]
        assert a["timer"] == "wall" and a["candidates"] == 1
        assert a["exact"] is True and a["winner_us"] == a["planned_us"] > 0
    f = tmp_path / "tune.json"
    tune.save(f)
    tune.clear()

    tune.merge(tune.load(f))
    e = tune.get_entry("qdot", (32, 256, 48), 4, 2, "torch")
    assert e["launch"] is None and e["pipeline"] == "off"
    assert e["timer"] == "wall" and e["us"] > 0
    ce = tune.get_entry("qconv", (2, 8, 8, 16, 3, 3, 1, 1, 24, 1), 8, 4,
                        "torch")
    assert ce["launch"] is None and ce["timer"] == "wall"
    with obs.enabled_scope():
        assert torch.equal(api.qdot_packed(params, xp), want_q)
        assert torch.equal(api.qconv(cparams, x), want_c)
        log = obs.dispatch_log()
    assert [d["tune_cache_hit"] for d in log] == [True, True]
    assert [d["pipeline_source"] for d in log] == ["tuned", "tuned"]


@pytest.mark.parametrize("which", ["stale", "reference_v3"])
def test_stale_and_reference_versions_fail_loudly(tmp_path, which):
    f = tmp_path / f"{which}.json"
    if which == "stale":
        f.write_text(json.dumps({"version": "repro_torch-0", "entries": {
            "qdot|8x128x128|a8w8|cuda": {"launch": None,
                                         "pipeline": "off"}}}))
    else:
        r_tune.record_block("qdot", (64, 256, 256), 8, 8, "pallas",
                            (64, 128, 128), pipeline="double_buffer",
                            us=3.0)
        r_tune.save(f)
        assert json.loads(f.read_text())["version"] == 3
    with pytest.raises(ValueError, match="unsupported tune-cache version"):
        tune.load(f)


def test_merge_conflict_incoming_wins():
    tune.record("qdot", (64, 256, 256), 4, 4, "cuda", None, pipeline="off")
    other = tune.TuneCache()
    other.put("qdot", (64, 256, 256), 4, 4, "cuda", LAUNCH,
              pipeline="double_buffer", us=3.0, timer="device")
    other.put("qdot", (8, 128, 128), 8, 8, "cuda", None)
    tune.merge(other)
    e = tune.get_entry("qdot", (64, 256, 256), 4, 4, "cuda")
    assert e["launch"] == LAUNCH
    assert e["pipeline"] == "double_buffer"
    assert tune.get_pipeline("qdot", (8, 128, 128), 8, 8, "cuda") == "off"


def _reset_env_preload(monkeypatch, path):
    monkeypatch.setenv(tune.CACHE_ENV, str(path))
    monkeypatch.setattr(tune, "_ENV_LOADED", False)


def test_env_preload_missing_path_warns(tmp_path, monkeypatch):
    _reset_env_preload(monkeypatch, tmp_path / "nope.json")
    with pytest.warns(RuntimeWarning, match="does not exist"):
        assert tune.get_entry("qdot", (8, 128, 128), 8, 8, "cuda") is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tune.get_entry("qdot", (8, 128, 128), 8, 8, "cuda")


def test_env_preload_stale_artifact_warns_not_raises(tmp_path, monkeypatch):
    f = tmp_path / "stale.json"
    f.write_text(json.dumps({"version": 3, "entries": {}}))
    _reset_env_preload(monkeypatch, f)
    with pytest.warns(RuntimeWarning, match="unsupported tune-cache"):
        assert tune.get_entry("qdot", (8, 128, 128), 8, 8, "cuda") is None


def test_env_preload_valid_artifact_loads(tmp_path, monkeypatch):
    tune.record("qdot", (64, 256, 256), 4, 4, "cuda", LAUNCH,
                pipeline="double_buffer")
    f = tmp_path / "tune.json"
    tune.save(f)
    tune.clear()
    _reset_env_preload(monkeypatch, f)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tune.get_pipeline("qdot", (64, 256, 256), 4, 4,
                                 "cuda") == "double_buffer"


@pytest.mark.parametrize("entry", [
    dict(launch=None, pipeline="double_buffer"),
    dict(launch=None, pipeline="off"),
    dict(launch=LAUNCH, pipeline="double_buffer")])
def test_cache_entry_never_changes_a_cpu_result(entry):
    gen = torch.Generator().manual_seed(1)
    params, xp = tune._mk_qdot_artifact(gen, 40, 300, 24, 8, 4)
    cparams, x = tune._mk_qconv_artifact(gen, 9, 7, 5, 20, 3, 3, 2, 1, 4, 2)
    want = {e: (api.qdot_packed(params, xp, epilogue=e),
                api.qconv(cparams, x, epilogue=e))
            for e in ("int", "raw", "dequant")}
    tune.record("qdot", (40, 384, 24), 8, 4, "torch", **entry)
    tune.record("qconv", (1, 9, 7, 5, 3, 3, 2, 1, 20, 1), 4, 2, "torch",
                None, entry["pipeline"])
    with obs.enabled_scope():
        for e, (q, c) in want.items():
            assert torch.equal(api.qdot_packed(params, xp, epilogue=e), q)
            assert torch.equal(api.qconv(cparams, x, epilogue=e), c)
        log = obs.dispatch_log()
    assert all(d["tune_cache_hit"] for d in log) and len(log) == 6
    assert {d["pipeline"] for d in log} == {entry["pipeline"]}


@pytest.mark.parametrize("m,k,n,a_bits", [
    (64, 64, 10, 8),          # one stage: the planned launch only
    (4096, 1152, 64, 8),      # a K split, 64-wide tile: one budget
    (256, 2048, 256, 8),      # 128-wide tile at A8: both budgets
    (256, 2048, 256, 4),      # sub-byte activations: one budget
])
def test_gemm_launches_lists_every_accepted_launch(m, k, n, a_bits):
    sms = 132
    launches = gk.gemm_launches(m, n, k, a_bits, sms)
    plan = gk.gemm_launch_plan(m, n, k, a_bits, sms)
    assert launches[0] == plan and len(set(launches)) == len(launches)
    stages = -(-k // 128)
    budgets = (1, 2) if a_bits == 8 and plan.nt == 128 else (1,)
    assert {(L.splits, L.min_blocks) for L in launches} == {
        (s, b) for s in range(1, min(stages, gk.MAX_SPLITS) + 1)
        for b in budgets}
    for L in launches:
        assert gk.gemm_launch_plan(m, n, k, a_bits, sms, splits=L.splits,
                                   min_blocks=L.min_blocks) == L
    # a launch outside that list does not fit the shape
    with pytest.raises(ValueError):
        gk.gemm_launch_plan(m, n, k, a_bits, sms,
                            splits=min(stages, gk.MAX_SPLITS) + 1)


def test_cli_on_the_cpu_writes_a_wall_timed_cache(tmp_path, capsys):
    out = tmp_path / "tc.json"
    tune.main(["--device", "cpu", "--shapes", "16x64x32", "--bits", "8x4",
               "--iters", "1", "--out", str(out)])
    text = capsys.readouterr().out
    assert "qdot 16x64x32 A8W4 [cpu] -> launch=null pipeline=off" in text
    loaded = tune.load(out)
    assert loaded.entries == {"qdot|16x128x32|a8w4|torch": {
        "launch": None, "pipeline": "off",
        "us": loaded.entries["qdot|16x128x32|a8w4|torch"]["us"],
        "timer": "wall"}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tune.main(["--out", str(out)])
