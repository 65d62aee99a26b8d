"""The port's observability layer (`repro_torch.obs`) case for case
against the reference's suite (`tests/test_obs.py`), and its counters and
trace against the reference's own, in one process.

* spans, counter handles and the disabled path; the dispatch log's
  sources (explicit / env / tuned / default) and its instant-event
  mirror; Chrome-trace export, `export_if_configured`, the report CLI,
  the ring-buffer bound, `time_call`, the env-knob registry;
* MAC/byte accounting at the api entry points against hand-computed
  GEMM and conv costs over the {8,4,2}^2 bit grid;
* parity, exact: the op-counter snapshot of `forward_int` over resnet8,
  qat-cnn plan (a) and mobilenet-tiny (both depthwise lowerings), smoke
  size (qat-cnn full width: plan (a) needs c3's 256 channels), A8 x
  W{8,4,2}, equals the reference's once its backend name reads
  ``torch``; a segmented `qdot` streams the packed bytes of the
  reference's ``qdot_mixed`` bucket; the port's trace passes
  the reference's `benchmarks.schema.check_trace`, and both packages'
  report renderers print the same text for it.
"""
import dataclasses
import importlib
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # `import benchmarks` from any rootdir
    sys.path.insert(0, str(ROOT))

from repro.deploy import policy as r_policy  # noqa: E402
from repro.kernels import api as r_api  # noqa: E402
from repro.obs import counters as r_counters  # noqa: E402
from repro.obs import report as r_report  # noqa: E402
from repro.obs import trace as r_obs  # noqa: E402
from repro.vision import models as r_models  # noqa: E402
from repro.vision.configs import get_vision_config as r_config  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as p_obs_pkg  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.quantize import (QuantSpec,  # noqa: E402
                                       QuantizedLinearParams)
from repro_torch.deploy import policy as p_policy  # noqa: E402
from repro_torch.kernels import api, tune  # noqa: E402
from repro_torch.kernels.qconv.ops import quantize_conv  # noqa: E402
from repro_torch.launch import vision as p_launch  # noqa: E402
from repro_torch.obs import counters as obs_counters  # noqa: E402
from repro_torch.obs import env as obsenv  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.vision import models as p_models  # noqa: E402
from repro_torch.vision.configs import get_vision_config as p_config  # noqa: E402,E501

from torch_bridge import np_tree, port_segmented  # noqa: E402

BITS = (8, 4, 2)


def _clear():
    for o in (obs, r_obs):
        o.disable()
        o.reset()
    obs_counters.reset()
    r_counters.reset()
    tune.clear()


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts and ends with empty buffers, disabled state and
    an empty tune cache, in both packages."""
    _clear()
    yield
    _clear()


# ------------------------------------------------------------- fixtures ---

def _mk_qdot_params(rng, a_bits, w_bits, K=256, N=128):
    lo, hi = packing.int_range(w_bits, True)
    w = torch.from_numpy(rng.integers(lo, hi + 1, size=(K, N)).astype(
        np.int8))
    return QuantizedLinearParams(
        w_packed=packing.pack(w, w_bits, axis=0), w_bits=w_bits,
        a_bits=a_bits, a_signed=False,
        kappa=torch.from_numpy(rng.integers(-64, 64, (N,)).astype(np.int32)),
        lam=torch.from_numpy(rng.integers(-2**16, 2**16, (N,)).astype(
            np.int32)),
        m=torch.from_numpy(rng.integers(0, 2**15, (N,)).astype(np.int32)),
        d=18, out_bits=8, k_logical=K)


def _mk_acts(rng, a_bits, M=16, K=256):
    lo, hi = packing.int_range(a_bits, False)
    return torch.from_numpy(rng.integers(lo, hi + 1, (M, K)).astype(np.int8))


def _mk_conv(rng, a_bits, w_bits, H=8, W=8, cin=24, cout=40):
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(
        np.float32) * 0.08)
    qp = quantize_conv(
        w, QuantSpec.weight(w_bits, float(w.abs().max())),
        torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32)
                         * .05 + .3),
        torch.zeros((cout,)), QuantSpec.activation(a_bits, 4.0),
        QuantSpec.activation(a_bits, 8.0), 1, 1)
    lo, hi = packing.int_range(a_bits, False)
    x = torch.from_numpy(rng.integers(lo, hi + 1, (1, H, W, cin)).astype(
        np.int8))
    return qp, x


# ----------------------------------------------------------------- spans ---

def test_span_records_attrs_and_nesting():
    with obs.enabled_scope():
        with obs.span("outer", cat="test", depth=0) as sp:
            sp.set(extra="late")
            with obs.span("inner", cat="test", depth=1):
                pass
    evs = obs.spans(cat="test")
    assert [e["name"] for e in evs] == ["inner", "outer"]  # exit order
    inner, outer = evs
    assert outer["args"] == {"depth": 0, "extra": "late"}
    assert inner["args"] == {"depth": 1}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["pid"] == 0 and inner["tid"] == outer["tid"]


def test_span_records_exception_and_reraises():
    with obs.enabled_scope():
        with pytest.raises(RuntimeError):
            with obs.span("boom", cat="test"):
                raise RuntimeError("x")
    (ev,) = obs.spans(name="boom")
    assert ev["args"]["error"] == "RuntimeError"


def test_span_sync_returns_its_value_and_finds_nested_tensors():
    t = torch.ones(3)
    with obs.enabled_scope():
        with obs.span("s") as sp:
            assert sp.sync(t) is t
            nested = {"a": [t, (t,)]}
            assert sp.sync(nested) is nested
    # no CUDA tensor anywhere: nothing to wait for
    assert obs._cuda_device({"a": [t, (t, 1)], "b": None}) is None


def test_counter_accumulates_and_survives_handle_caching():
    with obs.enabled_scope():
        c = obs.counter("hits")
        c.add().add(4)
        assert obs.counter_values() == {"hits": 5}
    c.add(100)
    assert obs.counter_values() == {"hits": 5}


def test_disabled_mode_is_a_noop(rng):
    """With observability off the api path records nothing, and
    span/counter return the shared null singletons."""
    assert obs.span("a") is obs.span("b")
    assert obs.counter("a") is obs.counter("b")
    api.qdot(_mk_qdot_params(rng, 8, 8), _mk_acts(rng, 8))
    qp, x = _mk_conv(rng, 8, 8)
    api.qconv(qp, x)
    assert obs.events() == []
    assert obs.dispatch_log() == []
    assert obs.counter_values() == {}
    assert obs_counters.snapshot() == {}


# ------------------------------------------------ profiler pass-through ---

def _profiled(fn, tmp_path):
    """``fn()`` under a CPU `torch.profiler` session; (its result, the
    session's ``user_annotation`` ranges as (name, start, end), by
    start), read from the exported Chrome trace as a harness reads it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    ranges = sorted((e["name"], float(e["ts"]), float(e["ts"] + e["dur"]))
                    for e in evs if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")
    return out, sorted(ranges, key=lambda r: r[1])


def _follow_one_another(ranges):
    return all(a[2] <= b[1] for a, b in zip(ranges, ranges[1:]))


def test_span_without_obs_or_profiler_is_the_null_span():
    assert obs.span("vision/stem", kind="conv") is obs._NULL_SPAN
    assert obs._recording_profiler() is None


def test_span_with_a_profiler_only_is_a_bare_range(tmp_path):
    t = torch.ones(3)

    def run():
        sp = obs.span("mirror", cat="test", extra=1)
        assert sp is not obs._NULL_SPAN and not isinstance(sp, obs.Span)
        with sp:
            assert sp.sync(t) is t
            sp.set(late=2)
        return sp

    _, ranges = _profiled(run, tmp_path)
    assert [r[0] for r in ranges] == ["mirror"]
    assert obs.events() == []
    assert obs.span("after") is obs._NULL_SPAN


def _tiny_vision_net():
    _, pq, images = _both_nets("resnet8", 4)
    return pq, torch.from_numpy(images)


def test_forward_int_mirrors_one_range_per_layer(tmp_path):
    """Observability off, a profiler recording: `quantize` and each layer
    of `forward_int` appear once, in layer order, one after another, and
    the ring buffer stays empty; the logits are unchanged."""
    pq, images = _tiny_vision_net()
    want = p_models.forward_int(pq, p_models.quantize(images,
                                                      pq.input_spec))
    got, ranges = _profiled(lambda: p_models.forward_int(
        pq, p_models.quantize(images, pq.input_spec)), tmp_path)
    assert torch.equal(got, want)
    vision = [r for r in ranges if r[0].startswith("vision/")]
    assert [r[0] for r in vision] == ["vision/quantize"] + [
        f"vision/{L.path}" for L, _ in pq.qlayers]
    assert _follow_one_another(vision)
    assert obs.events() == [] and obs_counters.snapshot() == {}


def test_obs_and_profiler_both_record(tmp_path):
    """Observability on and a profiler recording: each layer's ring-buffer
    event, with its kind and path, and its profiler range."""
    pq, images = _tiny_vision_net()
    with obs.enabled_scope():
        _, ranges = _profiled(lambda: p_models.forward_int(
            pq, p_models.quantize(images, pq.input_spec)), tmp_path)
    evs = [e for e in obs.spans(cat="span")
           if e["name"].startswith("vision/")]
    layers = [f"vision/{L.path}" for L, _ in pq.qlayers]
    assert [e["name"] for e in evs] == ["vision/quantize"] + layers
    assert [(e["args"]["kind"], e["args"]["path"]) for e in evs[1:]] == [
        (L.kind, L.path) for L, _ in pq.qlayers]
    names = [r[0] for r in ranges]
    assert all(n in names for n in ["vision/quantize"] + layers)


def _tiny_lm():
    """A two-layer dense LM (phi3's smoke config) served W4A8, and a
    token batch."""
    from repro_torch.configs import phi3_mini_3p8b
    from repro_torch.deploy.apply import int_skeleton
    from repro_torch.launch.convert import convert_params
    from repro_torch.models.api import build
    from repro_torch.nn.layers import QOFF, QuantConfig
    cfg = dataclasses.replace(phi3_mini_3p8b.smoke_config(), n_layers=2,
                              compute_dtype="float32")
    fp = build(dataclasses.replace(cfg, quant=QOFF)).init(0, device="cpu")
    model = build(dataclasses.replace(cfg, quant=QuantConfig(
        mode="int", w_bits=4, a_bits=8)))
    params = convert_params(int_skeleton(model.defs()), fp, 4)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)))
    return model, params, {"tokens": tokens}


def test_lm_prefill_mirrors_its_spans_in_order(tmp_path):
    model, params, batch = _tiny_lm()
    want, _ = model.prefill(params, batch)
    (got, _), ranges = _profiled(lambda: model.prefill(params, batch),
                                 tmp_path)
    assert torch.equal(got, want)
    lm = [r for r in ranges if r[0].startswith("lm/")]
    layer = ["lm/attn.qkv", "lm/attn.core", "lm/attn.out", "lm/mlp"]
    assert [r[0] for r in lm] == ["lm/embed"] + 2 * layer + ["lm/head"]
    assert _follow_one_another(lm)
    assert obs.events() == []


# -------------------------------------------------------------- counters ---

@pytest.mark.parametrize("ab", BITS)
@pytest.mark.parametrize("wb", BITS)
def test_qdot_mac_accounting(ab, wb, rng):
    M, K, N = 16, 256, 128
    params = _mk_qdot_params(rng, ab, wb, K=K, N=N)
    x = _mk_acts(rng, ab, M=M, K=K)
    with obs.enabled_scope():
        api.qdot(params, x)
    snap = obs_counters.snapshot()
    k = obs_counters.key("qdot", wb, ab, "torch", "off")
    assert set(snap) == {k}
    b = snap[k]
    assert b["calls"] == 1
    assert b["macs"] == M * K * N
    assert b["logical_bytes"] == M * K + K * N + M * N
    assert b["packed_bytes"] == (M * K // (8 // ab) + K * N // (8 // wb)
                                 + M * N)
    (ev,) = obs.spans(name="qdot", cat="kernel")
    assert ev["args"]["macs"] == M * K * N
    assert ev["args"]["w_bits"] == wb and ev["args"]["a_bits"] == ab
    assert ev["args"]["backend"] == "torch"
    assert obs_counters.parse_key(k) == {"op": "qdot", "w_bits": wb,
                                         "a_bits": ab, "backend": "torch",
                                         "pipeline": "off"}


def test_qdot_counts_the_k_padded_to_chunk(rng):
    """As the reference counts it (the kernel contracts less: the real K
    rounded up to 32)."""
    params = _mk_qdot_params(rng, 8, 8, K=128, N=16)
    params = dataclasses.replace(params, k_logical=70)
    with obs.enabled_scope():
        api.qdot(params, _mk_acts(rng, 8, M=4, K=70))
    (b,) = obs_counters.snapshot().values()
    assert b["macs"] == 4 * 128 * 16


@pytest.mark.parametrize("ab,wb", [(8, 8), (8, 4), (4, 2)])
def test_qconv_mac_accounting(ab, wb, rng):
    H = W = 8
    cin, cout, fh = 24, 40, 3
    qp, xq = _mk_conv(rng, ab, wb, H=H, W=W, cin=cin, cout=cout)
    with obs.enabled_scope():
        api.qconv(qp, xq)
    snap = obs_counters.snapshot()
    k = obs_counters.key("qconv", wb, ab, "torch", "off")
    assert k in snap
    assert snap[k]["macs"] == 1 * H * W * fh * fh * cin * cout
    assert snap[k]["calls"] == 1
    assert snap[k] == obs_counters.qconv_costs(
        (1, H, W, cin, fh, fh, 1, 1, cout, 1), ab, wb)


@pytest.mark.parametrize("wb", BITS)
def test_int_gemm_counts_one_call_at_the_real_k(wb, rng):
    """The dense layer's GEMM is counted at the K it contracts (not the
    K padded to CHUNK), with a kernel span; off, it records nothing."""
    M, K, k_real, N = 3, 256, 200, 24
    lo, hi = packing.int_range(wb, True)
    w = packing.pack(torch.from_numpy(rng.integers(lo, hi + 1, (K, N))
                                      .astype(np.int8)), wb, axis=0)
    x_q = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    x_q[:, k_real:] = 0
    scale = torch.full((N,), 0.25)

    def call():
        return api.int_gemm(x_q, w, a_bits=8, w_bits=wb, scale=scale,
                            out_dtype=torch.float32, k_logical=k_real)

    bare = call()
    assert obs_counters.snapshot() == {} and obs.events() == []
    with obs.enabled_scope():
        counted = call()
    assert torch.equal(bare, counted)
    k = obs_counters.key("int_gemm", wb, 8, "torch", "off")
    assert obs_counters.snapshot() == {k: obs_counters.qdot_costs(
        (M, k_real, N), 8, wb)}
    assert obs_counters.snapshot()[k]["macs"] == M * k_real * N
    (ev,) = obs.spans(name="int_gemm", cat="kernel")
    assert ev["args"]["macs"] == M * k_real * N
    assert obs.dispatch_log() == []


def test_counter_delta_attribution(rng):
    params = _mk_qdot_params(rng, 8, 4)
    x = _mk_acts(rng, 8)
    with obs.enabled_scope():
        api.qdot(params, x)
        before = obs_counters.snapshot()
        api.qdot(params, x)
        api.qdot(params, x)
        d = obs_counters.delta(obs_counters.snapshot(), before)
    k = obs_counters.key("qdot", 4, 8, "torch", "off")
    assert d[k]["calls"] == 2
    assert d[k]["macs"] == 2 * 16 * 256 * 128
    assert obs_counters.delta(before, before) == {}


# ---------------------------------------------------------- dispatch log ---

def _one_dispatch(rng, **kw):
    params = _mk_qdot_params(rng, 8, 4)
    x = _mk_acts(rng, 8)
    with obs.enabled_scope():
        api.qdot(params, x, **kw)
    log = obs.dispatch_log()
    assert len(log) == 1
    return log[0]


def test_dispatch_source_explicit(rng):
    ev = _one_dispatch(rng, pipeline="double_buffer")
    assert ev["backend"] == "torch" and ev["backend_source"] == "device"
    assert ev["pipeline"] == "double_buffer"
    assert ev["pipeline_source"] == "explicit"
    assert ev["env_pipeline"] is None
    assert ev["tune_cache_hit"] is False and ev["tune_winner"] is None
    assert ev["launch"] is None and ev["launch_source"] == "planned"
    assert ev["op"] == "qdot" and ev["w_bits"] == 4 and ev["a_bits"] == 8
    assert ev["shape"] == (16, 256, 128)


def test_dispatch_source_env(rng, monkeypatch):
    monkeypatch.setenv("REPRO_QPIPELINE", "double_buffer")
    ev = _one_dispatch(rng)
    assert ev["pipeline_source"] == "env"
    assert ev["env_pipeline"] == "double_buffer"
    assert ev["pipeline"] == "double_buffer"


def test_dispatch_source_default(rng):
    ev = _one_dispatch(rng)
    assert ev["backend_source"] == "device"
    assert ev["pipeline"] == "off" and ev["pipeline_source"] == "default"


def test_dispatch_source_tune_cache(rng):
    first = _one_dispatch(rng)
    assert first["tune_cache_hit"] is False
    obs.reset()
    tune.record("qdot", first["shape"], 8, 4, "torch",
                launch={"splits": 2, "min_blocks": 1},
                pipeline="double_buffer", us=12.5, timer="wall")
    ev = _one_dispatch(rng)
    assert ev["tune_cache_hit"] is True
    assert ev["launch"] == {"splits": 2, "min_blocks": 1}
    assert ev["launch_source"] == "tuned"
    assert ev["pipeline"] == "double_buffer"
    assert ev["pipeline_source"] == "tuned"
    assert ev["tune_winner"] == {"launch": {"splits": 2, "min_blocks": 1},
                                 "pipeline": "double_buffer", "us": 12.5,
                                 "timer": "wall"}
    # an explicit pipeline still wins over the tuned one
    obs.reset()
    ev = _one_dispatch(rng, pipeline="off")
    assert ev["pipeline"] == "off" and ev["pipeline_source"] == "explicit"
    assert ev["launch_source"] == "tuned"


def test_dispatch_mirrors_instant_event(rng):
    _one_dispatch(rng)
    instants = [e for e in obs.events() if e["ph"] == "i"]
    assert len(instants) == 1
    assert instants[0]["name"] == "dispatch:qdot"
    assert instants[0]["args"]["backend"] == "torch"
    assert obs.spans() == obs.spans(name="qdot")    # the instant is no span


# ---------------------------------------------------------- trace export ---

def test_chrome_trace_roundtrip(rng, tmp_path):
    from benchmarks import schema

    with obs.enabled_scope():
        api.qdot(_mk_qdot_params(rng, 8, 4), _mk_acts(rng, 8))
        path = obs.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.loads(pathlib.Path(path).read_text())
    schema.check_trace(doc)
    assert doc["repro"]["version"] == obs.TRACE_SCHEMA_VERSION
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"qdot", "dispatch:qdot"} <= names
    assert "qdot|w4a8|torch|off" in doc["repro"]["op_counters"]
    s = p_obs_pkg.summary()
    assert s["spans"]["qdot"]["count"] == 1 and s["dispatch_events"] == 1


def test_export_if_configured(tmp_path, monkeypatch):
    assert obs.export_if_configured(str(tmp_path / "no.json")) is None
    with obs.enabled_scope():
        obs.counter("x").add()
        assert obs.export_if_configured(None) is None
        target = tmp_path / "via_env.json"
        monkeypatch.setenv("REPRO_OBS_TRACE", str(target))
        assert obs.export_if_configured("ignored.json") == str(target)
    assert json.loads(target.read_text())["repro"]["counters"] == {"x": 1}


def test_report_cli_renders_table(rng, tmp_path, capsys):
    with obs.enabled_scope():
        api.qdot(_mk_qdot_params(rng, 8, 4), _mk_acts(rng, 8))
        path = obs.export_chrome_trace(str(tmp_path / "t.json"))
    assert report.main([path]) == 0
    out = capsys.readouterr().out
    assert "MAC/us per bit-width" in out
    assert "dispatch decisions" in out
    assert "qdot" in out and "backend<-device" in out
    assert report.main([str(tmp_path / "missing.json")]) == 2


def test_ring_buffer_bounds_memory():
    with obs.enabled_scope():
        obs.enable(capacity=8)
        for i in range(50):
            with obs.span(f"s{i}", cat="test"):
                pass
        evs = obs.events()
    assert len(evs) == 8
    assert evs[-1]["name"] == "s49"
    obs.enable(capacity=obs.DEFAULT_CAPACITY)
    obs.disable()


def test_reset_clears_spans_counters_and_op_counters(rng):
    with obs.enabled_scope():
        obs.counter("c").add()
        api.qdot(_mk_qdot_params(rng, 8, 8), _mk_acts(rng, 8))
    assert obs.events() and obs_counters.snapshot()
    p_obs_pkg.reset()
    assert obs.events() == [] and obs.dispatch_log() == []
    assert obs.counter_values() == {} and obs_counters.snapshot() == {}


# ----------------------------------------------------------- shared timer ---

def test_time_call_counts_warmup_and_iters():
    calls = []
    us = obs.time_call(lambda: calls.append(1), warmup=2, iters=5)
    assert us >= 0 and len(calls) == 7
    calls.clear()
    obs.time_call(lambda a, b: calls.append(a + b), 1, 2, warmup=1,
                  iters=3)
    assert calls == [3] * 4


# -------------------------------------------------------------- env knobs ---

def test_env_get_validates(monkeypatch):
    with pytest.raises(KeyError, match="undeclared env knob"):
        obsenv.get("REPRO_NOT_A_KNOB")
    monkeypatch.setenv("REPRO_QPIPELINE", "triple_buffer")
    with pytest.raises(ValueError, match="choices"):
        obsenv.get("REPRO_QPIPELINE")
    monkeypatch.setenv("REPRO_QPIPELINE", "double_buffer")
    assert obsenv.get("REPRO_QPIPELINE") == "double_buffer"
    monkeypatch.delenv("REPRO_QPIPELINE")
    assert obsenv.get("REPRO_QPIPELINE") is None
    monkeypatch.setenv("REPRO_OBS", "maybe")
    with pytest.raises(ValueError, match="not boolean"):
        obsenv.get_bool("REPRO_OBS")
    monkeypatch.setenv("REPRO_OBS", "yes")
    assert obsenv.get_bool("REPRO_OBS") is True
    monkeypatch.setenv("REPRO_OBS", "0")
    assert obsenv.get_bool("REPRO_OBS") is False


@pytest.mark.parametrize("name", ["REPRO_TYPO_KNOB", "REPRO_QBACKEND",
                                  "REPRO_EXTRA_XLA"])
def test_env_warn_unknown(name, monkeypatch):
    """A typo, and the reference's knobs the port does not have (its
    backend is the device; there is no XLA), warn as unknown."""
    monkeypatch.setenv(name, "1")
    monkeypatch.setattr(obsenv, "_warned_unknown", False)
    with pytest.warns(UserWarning, match=name):
        assert name in obsenv.warn_unknown()
    assert name in obsenv.warn_unknown()     # again: reported, silently


def test_env_table_covers_every_knob():
    t = obsenv.table()
    assert set(obsenv.KNOBS) == {
        "REPRO_OBS", "REPRO_OBS_TRACE", "REPRO_QPIPELINE",
        "REPRO_QTUNE_CACHE", "REPRO_TORCH_BUILD_DIR"}
    for name in obsenv.KNOBS:
        assert f"`{name}`" in t


def test_port_reads_repro_knobs_through_the_registry():
    """No ``os.environ`` read of a REPRO_* name outside obs/env.py."""
    read = re.compile(r"environ(\.get)?\s*[\[(]\s*[\"']REPRO_")
    src = ROOT / "src" / "repro_torch"
    for path in src.rglob("*.py"):
        if path.name == "env.py" and path.parent.name == "obs":
            continue
        for line in path.read_text().splitlines():
            assert not read.search(line), (path, line)
    assert read.search('os.environ.get("REPRO_OBS")')


# ----------------------------------------------- parity with the reference ---

def _renamed(snap, backend):
    """A reference op-counter snapshot of ``backend`` with the backend
    named as the port's CPU backend."""
    out = {}
    for k, v in snap.items():
        d = r_counters.parse_key(k)
        assert d["backend"] == backend, k
        out[obs_counters.key(d["op"], d["w_bits"], d["a_bits"], "torch",
                             d["pipeline"])] = v
    return out


# The reference's backend the parity runs on. Not `xla`: its conv is
# im2col + a nested, counted `xla` qdot call, so each conv would count
# twice; `eager_ref` runs each op as one uncounted oracle, as the port's
# plain versions run.
REF_BACKEND = "eager_ref"


def _ref_forward(rq, x, lowering):
    """The reference's `forward_int` on `REF_BACKEND` with every
    depthwise layer forced through ``lowering``."""
    stream, edges = x, {}
    for L, q in rq.qlayers:
        xin = edges[L.input_from] if L.input_from else stream
        if L.kind == "dwconv":
            y = q.apply(xin, backend=REF_BACKEND, lowering=lowering)
        elif L.kind in ("conv", "linear"):
            y = q.apply(xin, backend=REF_BACKEND)
        elif L.kind == "add":
            y = q.apply(xin, edges[L.skip_from])
        else:
            y = q.apply(xin)
        if L.save_as:
            edges[L.save_as] = y
        if not L.branch:
            stream = y
    return stream


def _uniform_ref_plan(cfg, w_bits):
    return r_policy.PrecisionPlan(
        rules=tuple(r_policy.PlanRule(pattern=L.path, w_bits=w_bits)
                    for L in cfg.layers
                    if L.kind in r_models.COMPUTE_KINDS),
        default_w_bits=w_bits)


def _plan_a(policy):
    return policy.PrecisionPlan(rules=(policy.PlanRule(
        pattern="c3", w_bits=8, segments=((0, 128, 8), (128, 256, 4))),))


def _both_nets(net, w_bits):
    """(reference net, port net, images) from the same seeded numbers."""
    smoke = net != "qat-cnn"
    rcfg, pcfg = r_config(net, smoke=smoke), p_config(net, smoke=smoke)
    rng = np.random.default_rng(0)
    batches = [rng.uniform(0, 1, size=(4, *rcfg.in_hw, rcfg.in_ch)).astype(
        np.float32) for _ in range(2)]
    rfp = r_models.init_fp(rcfg, seed=0)
    absmax = r_models.collect_absmax(rcfg, rfp, batches)
    if w_bits is None:
        rplan, pplan = _plan_a(r_policy), _plan_a(p_policy)
    else:
        rplan = _uniform_ref_plan(rcfg, w_bits)
        pplan = p_launch.uniform_plan(pcfg, w_bits, 8)
    rq = r_models.quantize_net(rcfg, rfp, absmax, plan=rplan)
    pq = p_models.quantize_net(
        pcfg, convert.fp_params_from_numpy(np_tree(rfp), "cpu"), absmax,
        plan=pplan, device="cpu")
    images = rng.uniform(0, 1, size=(3, *rcfg.in_hw, rcfg.in_ch)).astype(
        np.float32)
    return rq, pq, images


NETS = ([("resnet8", w, "auto") for w in BITS]
        + [("mobilenet-tiny", w, low) for w in BITS
           for low in ("qdot", "per_group")]
        + [("qat-cnn", None, "auto")])


@pytest.mark.parametrize("net,w_bits,lowering", NETS,
                         ids=[f"{n}-W{w or 'planA'}-{lw}"
                              for n, w, lw in NETS])
def test_forward_int_op_counters_equal_reference(net, w_bits, lowering):
    rq, pq, images = _both_nets(net, w_bits)
    with r_obs.enabled_scope():
        rl = _ref_forward(rq, r_models.quantize_input(rq, images),
                          "qdot" if lowering == "auto" else lowering)
    with obs.enabled_scope():
        pl = p_models.forward_int(pq, p_models.quantize_input(pq, images),
                                  lowering=lowering)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    want = _renamed(r_counters.snapshot(), REF_BACKEND)
    got = obs_counters.snapshot()
    assert got == want
    assert {obs_counters.parse_key(k)["op"] for k in got} == {"qdot",
                                                             "qconv"}
    # one dispatch event and one kernel span per call, both packages
    calls = sum(v["calls"] for v in got.values())
    assert len(obs.dispatch_log()) == len(r_obs.dispatch_log()) == calls
    assert len(obs.spans(cat="kernel")) == calls


def test_segmented_qdot_packed_bytes_equal_reference():
    r_q = importlib.import_module("repro.core.quantize")
    from repro.core import packing as r_pack

    rng = np.random.default_rng(3)
    runs = ((0, 128, 8), (128, 256, 2), (256, 300, 4))
    k, m = 200, 9
    w = np.zeros((k, 300), np.int8)
    for s, e, b in runs:
        lo, hi = r_pack.int_range(b, True)
        w[:, s:e] = rng.integers(lo, hi + 1, size=(k, e - s))
    ref = r_q.quantize_linear_segmented(
        jnp.asarray(w), r_pack.SegmentMap(runs),
        rng.integers(-127, 128, 300).astype(np.int32),
        rng.integers(-2**18, 2**18, 300).astype(np.int32),
        rng.integers(0, 2**15, 300).astype(np.int32), a_bits=8,
        a_signed=False, d=18, out_bits=8, assert_range=True)
    x = rng.integers(0, 128, size=(m, k)).astype(np.int8)
    with r_obs.enabled_scope():
        r_api.qdot(ref, jnp.asarray(x), backend="xla")
    with obs.enabled_scope():
        api.qdot(port_segmented(ref), torch.from_numpy(x))
    got = obs_counters.snapshot()
    want = _renamed(r_counters.snapshot(), "xla")
    assert list(got) == ["qdot_mixed|w8a8|torch|off"]
    assert got == want
    assert got["qdot_mixed|w8a8|torch|off"]["packed_bytes"] == (
        m * 256 + r_pack.SegmentMap(runs).packed_bytes(k) + m * 300)


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A Chrome trace of the port: a served resnet8 wave and a mobilenet
    forward, spans, counters and dispatch events."""
    from repro_torch.serve.engine import VisionEngine
    _clear()
    _, pq, images = _both_nets("resnet8", 4)
    _, mq, mimages = _both_nets("mobilenet-tiny", 2)
    with obs.enabled_scope():
        with obs.span("serve.generate", cat="serve", requests=3):
            VisionEngine(pq, batch_size=2, device="cpu").run(images)
        p_models.forward_int(mq, p_models.quantize_input(mq, mimages),
                             lowering="per_group")
        path = obs.export_chrome_trace(
            str(tmp_path_factory.mktemp("trace") / "t.json"))
    _clear()
    return path


def test_port_trace_passes_reference_schema(port_trace):
    from benchmarks import schema

    doc = report.load_trace(port_trace)
    schema.check_trace(doc)
    assert {r["backend"] for r in report.mac_table(doc)} == {"torch"}
    ds = report.dispatch_summary(doc)
    assert ds["events"] == sum(v["calls"] for v in
                               doc["repro"]["op_counters"].values())


def test_both_renderers_print_the_same_text(port_trace):
    doc = report.load_trace(port_trace)
    assert r_report.load_trace(port_trace) == doc
    text = report.render(doc)
    assert text == r_report.render(doc)
    assert "serving runtime" in text and "qconv" in text
    assert report.top_spans(doc) == r_report.top_spans(doc)
    assert report.serving_summary(doc) == r_report.serving_summary(doc)
    bench = {"workload": {"requests": 4, "qps": 2.0, "slots": 2, "seed": 0},
             "rows": [{"policy": "wave", "throughput_rps": 1.0,
                       "throughput_tps": 2.0,
                       "latency_s": {"p50": 1.0, "p99": 2.0}, "steps": 3,
                       "occupancy": {"mean": 0.5},
                       "queue_depth": {"max": 1}}]}
    assert report.render_serving_bench(bench) == \
        r_report.render_serving_bench(bench)
