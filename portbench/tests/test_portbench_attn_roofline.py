"""The fused attention kernel's roofline readers on a made-up timeline:
two prefill calls of one layer's attention each, and a program without
the kernel (the readers return None, the metric is left out)."""
import json
import pathlib

import pytest

from portbench.harness import spec, trace, work, work_mla_moe

ROOT = pathlib.Path(__file__).resolve().parents[2]
PEAKS = {"bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes": 3.35e12}


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(kernel, per_step=2, dur=1000.0):
    evs = []
    for t in (0.0, 10_000.0):
        evs.append(_ev("user_annotation", "step", t, 9_000))
        for i in range(per_step):
            evs.append(_ev("kernel", kernel, t + 100 + 2_000 * i, dur))
        evs.append(_ev("kernel", "qmatmul_kernel", t + 6_000, 500))
    return trace.parse(evs)


def _ctx(config, tr, rows=8, seq=2048):
    return {"config": config, "trace": tr, "peaks": PEAKS,
            "steps": [(0.0, 1.0, {"tokens": rows * seq, "rows": rows,
                                  "seq": seq})] * 2}


def _reader(name):
    return spec.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def _config(name):
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("metric,config,flops", [
    ("attn_roofline.prefill", "phi3-mini-3.8b-w4a8",
     work.lm_attention_flops),
    ("attn_roofline.moe-prefill", "kimi-k2-instruct-w4a8-ep8",
     work_mla_moe.attention_flops)])
def test_share_of_the_causal_work_at_the_bf16_peak(metric, config, flops):
    cfg = _config(config)
    tr = _trace("void (anonymous namespace)::attn_fwd_kernel<96, 128>"
                "(AttnArgs)")
    got = _reader(metric).read(_ctx(cfg, tr))
    # two steps of two 1 ms launches: 2 ms of kernel a call
    want = 100.0 * flops(cfg, 8, 2048) / PEAKS["bf16_flops"] / 2e-3
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", ["attn_roofline.prefill",
                                    "attn_roofline.moe-prefill"])
def test_none_without_the_kernel(metric):
    reader = _reader(metric)
    cfg = _config("phi3-mini-3.8b-w4a8")
    tr = _trace("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n")
    assert reader.read(_ctx(cfg, tr)) is None
    assert reader.read(_ctx(cfg, None)) is None
    ctx = _ctx(cfg, tr)
    ctx["peaks"] = None
    assert reader.read(ctx) is None


def test_metrics_resolve_for_their_cells():
    """Each cell that lists the readers resolves them; ResNet-8 does
    not report them."""
    want = {"phi3-mini-w4a8.prefill-8x2048": "attn_roofline.prefill",
            "phi3-mini-w4a8.prefill-64x256": "attn_roofline.prefill",
            "kimi-k2-w4a8-ep8.prefill-8x2048": "attn_roofline.moe-prefill"}
    both = set(want.values())
    for cell, name in want.items():
        names = {m.name for m in spec.resolve(ROOT, cell).per_layer}
        assert names & both == {name}
    names = {m.name for m in
             spec.resolve(ROOT, "resnet8-w4a8.frames-16384").per_layer}
    assert not any(n.startswith("attn_roofline") for n in names)
