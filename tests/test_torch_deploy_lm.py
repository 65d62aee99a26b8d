"""The port's LM deployment flow (`repro_torch.deploy.calibrate.calibrate`,
`repro_torch.launch.deploy`, `launch/serve.py --ckpt`) against the
reference's, on the CPU, from the same numpy weights and token batches.

Tolerances, and why:
- float32 compute: a_absmax within 1e-5 relative (the max of a float32
  activation, a few layers deep, in another rounding order: 4e-7 seen);
  sq_ref, sq_err and sens within 1e-4 relative (float32 matmuls and sums
  in another order, and an activation code on a .5 boundary that flips:
  gemma3's six layers reach 3e-5 at W8, the others 1e-6); the
  per-channel sens(b) within 1e-4 of the path's sens(b), absolute (one
  channel holds a flipped code's whole error: 2e-3 of that channel);
- bfloat16 compute (the smoke configs as they are, the deploy CLI):
  a_absmax within 2e-2 relative (two bfloat16 ulps of 2^-8 after a
  layer or two: 9e-3 seen), the error sums within 5e-2 (1e-2 seen).
Exact: the weight-only fallback's taps, layers and shapes; plan JSON
from the reference's stats; the artifact directories the two CLIs write
from one checkpoint and one plan, file for file.
"""
import dataclasses
import importlib
import json
import pathlib
import re
import sys
import warnings

import numpy as np
import pytest

from repro.ckpt import checkpoint as r_ckpt
from repro.deploy import calibrate as r_cal
from repro.deploy import planner as r_plan
from repro.deploy import policy as r_policy
from repro.launch import deploy as r_deploy
from repro.models import api as r_api
from repro_torch.convert import fp_params_from_numpy
from repro_torch.deploy import calibrate as p_cal
from repro_torch.deploy import planner as p_plan
from repro_torch.launch import deploy as p_deploy
from repro_torch.launch import serve as p_serve
from repro_torch.models import api as p_api

from torch_bridge import fp_numpy

F32 = dict(absmax=1e-5, stats=1e-4)
BF16 = dict(absmax=2e-2, stats=5e-2)
# archs whose calibration replays the model; the MoE archs at 1 layer
REPLAY = {"qwen2p5_3b": {}, "gemma3_1b": {}, "olmo_1b": {},
          "phi3_mini_3p8b": {}, "kimi_k2_1t": {"n_layers": 1},
          "llama4_maverick_400b": {"n_layers": 1}}
WEIGHT_ONLY = ["mamba2_370m", "recurrentgemma_9b", "seamless_m4t_large_v2",
               "llama3p2_vision_90b"]
ARCH = "qwen2.5-3b"


def _configs(mod, **over):
    return tuple(dataclasses.replace(importlib.import_module(
        f"{pkg}.configs.{mod}").smoke_config(), **over)
        for pkg in ("repro", "repro_torch"))


def _batches(vocab, seed=3, n=2, b=2, s=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=(b, s)).astype(np.int32)
            for _ in range(n)]


def _calibrate_both(mod, **over):
    rc, pc = _configs(mod, **over)
    fp = fp_numpy(r_api.build(rc).defs(), seed=5)
    batches = _batches(rc.vocab)
    rstats = r_cal.calibrate(r_api.build(rc), fp, batches)
    pstats = p_cal.calibrate(p_api.build(pc), fp_params_from_numpy(
        fp, "cpu"), batches)
    return rstats, pstats


def _check_stats(pstats, rstats, tol, replayed=True):
    assert list(pstats) == list(rstats)
    for path, r in rstats.items():
        p = pstats[path]
        assert (p.layers, p.d_in, p.d_out, p.taps) == \
            (r.layers, r.d_in, r.d_out, r.taps), path
        if replayed:
            assert p.a_absmax == pytest.approx(r.a_absmax,
                                               rel=tol["absmax"]), path
        else:
            assert p.a_absmax == r.a_absmax == 4.0
        assert p.sq_ref == pytest.approx(r.sq_ref, rel=tol["stats"]), path
        assert sorted(p.sq_err) == sorted(r.sq_err) == [2, 4, 8]
        for b in (8, 4, 2):
            assert p.sq_err[b] == pytest.approx(
                r.sq_err[b], rel=tol["stats"]), (path, b)
            assert p.sens(b) == pytest.approx(r.sens(b), rel=tol["stats"])
            np.testing.assert_allclose(p.col_sens(b), r.col_sens(b),
                                       rtol=0, atol=tol["stats"] * r.sens(b),
                                       err_msg=f"{path} W{b}")


@pytest.mark.parametrize("mod", sorted(REPLAY))
def test_calibrate_replay_matches_reference(mod):
    rstats, pstats = _calibrate_both(mod, compute_dtype="float32",
                                     **REPLAY[mod])
    n_layers = _configs(mod, **REPLAY[mod])[1].n_layers
    assert all(st.taps == 2 * n_layers for st in pstats.values())
    _check_stats(pstats, rstats, F32)


@pytest.mark.parametrize("mod", ["qwen2p5_3b", "gemma3_1b"])
def test_calibrate_replay_bfloat16_compute(mod):
    rstats, pstats = _calibrate_both(mod)
    _check_stats(pstats, rstats, BF16)


@pytest.mark.parametrize("mod", WEIGHT_ONLY)
def test_calibrate_weight_only_fallback_matches_reference(mod):
    rstats, pstats = _calibrate_both(mod)
    assert all(st.taps == 1 for st in pstats.values())
    _check_stats(pstats, rstats, F32, replayed=False)


def test_moe_replay_taps_the_shared_expert_only():
    _, pc = _configs("kimi_k2_1t", n_layers=1, compute_dtype="float32")
    fp = fp_numpy(r_api.build(_configs("kimi_k2_1t")[0]).defs(), seed=5)
    stats = p_cal.calibrate(p_api.build(pc), fp_params_from_numpy(
        fp, "cpu"), _batches(pc.vocab))
    assert sorted(stats) == [f"layers/attn/{w}" for w in
                             ("wk", "wo", "wq", "wv")] + [
        f"layers/moe/shared/{w}" for w in ("wg", "wi", "wo")]
    assert all(st.taps == 2 for st in stats.values())


def _port_stats(rstats):
    return {p: p_cal.CalibStats(**{
        f.name: getattr(st, f.name) for f in dataclasses.fields(st)})
        for p, st in rstats.items()}


@pytest.fixture(scope="module")
def ref_stats():
    """The reference's stats of each replayed arch and one fallback."""
    out = {}
    for mod in ("qwen2p5_3b", "gemma3_1b", "kimi_k2_1t", "mamba2_370m"):
        rc, _ = _configs(mod)
        fp = fp_numpy(r_api.build(rc).defs(), seed=5)
        out[mod] = r_cal.calibrate(r_api.build(rc), fp,
                                   _batches(rc.vocab))
    return out


@pytest.mark.parametrize("granularity", ["layer", "channel_group"])
@pytest.mark.parametrize("mod", ["qwen2p5_3b", "gemma3_1b", "kimi_k2_1t",
                                 "mamba2_370m"])
def test_plan_json_identical_given_reference_stats(ref_stats, mod,
                                                   granularity):
    rstats = ref_stats[mod]
    pstats = _port_stats(rstats)
    for frac in (0.0, 0.3, 1.0):
        rb = r_plan.auto_budget(rstats, frac=frac)
        assert p_plan.auto_budget(pstats, frac=frac) == rb
        meta = {"arch": mod, "smoke": True}
        want = r_plan.plan_mixed_precision(
            rstats, rb, granularity=granularity, meta=meta)
        got = p_plan.plan_mixed_precision(
            pstats, rb, granularity=granularity, meta=meta)
        assert got.to_json() == want.to_json()


# ------------------------------------------------------------ the CLIs ---

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """qwen2.5-3b smoke fp weights from numpy, in a checkpoint the
    reference wrote."""
    d = tmp_path_factory.mktemp("ckpt")
    rc = r_api.get_smoke_config(ARCH)
    r_ckpt.save(d, 0, {"params": fp_numpy(r_api.build(rc).defs(), seed=7)})
    return d


def _ref_main(monkeypatch, args):
    monkeypatch.setattr(sys, "argv", ["repro.launch.deploy"] + args)
    r_deploy.main()


def _files(d: pathlib.Path):
    return {str(f.relative_to(d)): f.read_bytes()
            for f in sorted(d.rglob("*")) if f.is_file()}


def _assert_same_dirs(port: pathlib.Path, ref: pathlib.Path):
    pf, rf = _files(port), _files(ref)
    assert sorted(pf) == sorted(rf)
    for name, data in rf.items():
        assert pf[name] == data, name


def _bytes_line(out):
    m = re.search(r"artifact bytes: fp ([\d,]+)\s+uniform-w8 ([\d,]+)\s+"
                  r"mixed ([\d,]+)", out)
    assert m, out
    return [int(g.replace(",", "")) for g in m.groups()]


@pytest.fixture(scope="module")
def deployed(ckpt, tmp_path_factory):
    """Both CLIs calibrate, plan and pack the reference's checkpoint."""
    d = tmp_path_factory.mktemp("deploy")
    mp = pytest.MonkeyPatch()
    try:
        common = ["--arch", ARCH, "--smoke", "--ckpt", str(ckpt)]
        _ref_main(mp, common + ["--out", str(d / "r.json"), "--artifact",
                                str(d / "r_art")])
        summary = p_deploy.main(common + [
            "--device", "cpu", "--out", str(d / "p.json"), "--artifact",
            str(d / "p_art")])
    finally:
        mp.undo()
    return d, summary


def test_deploy_cli_calibrated_plan_matches_reference(deployed):
    d, summary = deployed
    want = json.loads((d / "r.json").read_text())
    got = json.loads((d / "p.json").read_text())
    assert {r["pattern"]: r["w_bits"] for r in got["rules"]} == \
        {r["pattern"]: r["w_bits"] for r in want["rules"]}
    assert len({r["w_bits"] for r in got["rules"]}) >= 2
    for g, w in zip(got["rules"], want["rules"]):
        assert g["a_absmax"] == pytest.approx(w["a_absmax"],
                                              rel=BF16["absmax"])
    plan = summary["plan"]
    assert summary["mixed_bytes"] < summary["w8_bytes"] < summary["fp_bytes"]
    assert (d / "p_art" / "plan.json").read_text() == plan.to_json()


def test_deploy_cli_artifact_identical_to_reference_from_one_plan(
        ckpt, deployed, tmp_path, monkeypatch, capsys):
    """Given the reference's plan, the two CLIs write the same files."""
    d, _ = deployed
    common = ["--arch", ARCH, "--smoke", "--ckpt", str(ckpt),
              "--from-plan", str(d / "r.json")]
    _ref_main(monkeypatch, common + ["--out", str(tmp_path / "r.json"),
                                     "--artifact", str(tmp_path / "r_art")])
    p_deploy.main(common + ["--device", "cpu", "--out",
                            str(tmp_path / "p.json"), "--artifact",
                            str(tmp_path / "p_art")])
    out = capsys.readouterr().out
    assert out.count("deploy done") == 2 and "packed artifact ->" in out
    _assert_same_dirs(tmp_path / "p_art", tmp_path / "r_art")
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "r.json").read_bytes()


def test_serve_ckpt_plan_params_bytes_equal_mixed_bytes(ckpt, deployed,
                                                        capsys):
    d, summary = deployed
    capsys.readouterr()
    out = p_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--ckpt", str(ckpt), "--plan", str(d / "p.json"),
                        "--requests", "3", "--batch", "2", "--max-new",
                        "4"])
    text = capsys.readouterr().out
    m = re.search(r"\((\d[\d,]*) bytes\)", text)
    assert m and int(m.group(1).replace(",", "")) == summary["mixed_bytes"]
    assert len(out) == 3 and all(len(r.out) == 4 for r in out)
    assert "tok/s" in text


def test_deploy_cli_prints_the_reference_lines(ckpt, tmp_path, capsys):
    p_deploy.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt",
                   str(ckpt), "--out", str(tmp_path / "p.json")])
    out = capsys.readouterr().out
    fp_b, w8_b, mixed_b = _bytes_line(out)
    assert mixed_b < w8_b < fp_b
    assert re.search(r"layers/mlp/wi\s+W\dA8\s+absmax=", out)
    assert "budget " in out and out.rstrip().endswith("deploy done")
    assert not (tmp_path / "art").exists()


def test_deploy_cli_seeded_params_without_ckpt(tmp_path):
    summary = p_deploy.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--out", str(tmp_path / "p.json")])
    assert summary["plan"].meta["arch"] == "qwen-smoke"
    assert summary["calibrate_s"] > 0


# one plan per schema version `policy.load_plan` reads; a v1 rule's
# `use_kernel` pins a reference backend, which the next test covers
PLANS = {
    1: {"version": 1, "default": {"w_bits": 8, "a_bits": 8},
        "rules": [{"pattern": "layers/mlp/*", "w_bits": 4, "a_bits": 8,
                   "a_absmax": 3.0}], "meta": {}},
    2: {"version": 2, "default": {"w_bits": 4, "a_bits": 8},
        "rules": [{"pattern": "layers/attn/wq", "w_bits": 2, "a_bits": 8,
                   "backend": "torch", "a_absmax": None}], "meta": {}},
    3: {"version": 3, "default": {"w_bits": 8, "a_bits": 8},
        "rules": [{"pattern": "layers/mlp/w?", "w_bits": 2, "a_bits": 8,
                   "backend": None, "a_absmax": 2.5,
                   "pipeline": "double_buffer"}], "meta": {"note": "v3"}},
    4: {"version": 4, "default": {"w_bits": 4, "a_bits": 8},
        "rules": [{"pattern": "layers/mlp/wi", "w_bits": 2, "a_bits": 8,
                   "backend": None, "a_absmax": None, "pipeline": None,
                   "segments": [[0, 128, 2]]}], "meta": {}},
}


@pytest.mark.parametrize("version", sorted(PLANS))
def test_deploy_cli_from_plan_resaves_every_schema(ckpt, tmp_path, version,
                                                   capsys):
    src = tmp_path / f"v{version}.json"
    src.write_text(json.dumps(PLANS[version]))
    summary = p_deploy.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--ckpt", str(ckpt), "--from-plan", str(src),
                             "--out", str(tmp_path / "p.json"),
                             "--artifact", str(tmp_path / "art")])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = r_policy.load_plan(src).to_json()
    assert (tmp_path / "p.json").read_text() == want
    assert (tmp_path / "art" / "plan.json").read_text() == want
    out = capsys.readouterr().out
    assert f"re-saved plan {src}" in out and "schema v4" in out
    assert "uniform-w8" not in out          # no planner byte accounting
    assert summary["mixed_bytes"] < summary["fp_bytes"]


def test_deploy_cli_from_plan_refuses_a_v1_use_kernel_pin(ckpt, tmp_path):
    """A v1 rule's `use_kernel` maps onto the reference's 'xla' /
    'pallas_interpret' backends, which the port does not have."""
    v1 = dict(PLANS[1], rules=[dict(PLANS[1]["rules"][0],
                                    use_kernel=False)])
    src = tmp_path / "v1.json"
    src.write_text(json.dumps(v1))
    with pytest.warns(DeprecationWarning, match="use_kernel"):
        assert r_policy.load_plan(src).rules[0].backend == "xla"
    with pytest.raises(ValueError, match="'xla' is not a backend of this "
                       "port"):
        p_deploy.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--ckpt", str(ckpt), "--from-plan", str(src),
                       "--out", str(tmp_path / "p.json")])


def test_deploy_cli_from_plan_warns_on_ignored_flags(ckpt, tmp_path, capsys):
    src = tmp_path / "v4.json"
    src.write_text(json.dumps(PLANS[4]))
    p_deploy.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--ckpt",
                   str(ckpt), "--from-plan", str(src), "--bits", "8,4",
                   "--out", str(tmp_path / "p.json")])
    assert "warning: --bits ignored with --from-plan" in \
        capsys.readouterr().out
