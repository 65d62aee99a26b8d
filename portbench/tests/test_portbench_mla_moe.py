"""The latent-attention MoE system (`systems/mla_moe_lm.py`) at smoke size
on the CPU: a whole run is ``correct`` against the plain reference, the
A4 control is not, nor is a run with a fault confined to the routed
experts, the port's packed tree holds the per-layer weights the
reference reads, and the yardstick of its metrics counts the
configuration's shapes."""
import copy
import dataclasses
import json
import time

import pytest

import smoke
from portbench.harness import runner, spec, work_mla_moe

CELL = "kimi-smoke.prefill-2x12"


def kimi_smoke() -> dict:
    """The benchmark's file at the registered smoke arch's sizes: 3
    layers (1 dense), 8 of 16 experts held from offset 8."""
    cfg = smoke.real_config("kimi-k2-instruct-w4a8-ep8")
    cfg = copy.deepcopy(cfg)
    cfg.update(name="kimi-smoke", arch="kimi-instruct-smoke",
               hidden_size=64, num_attention_heads=4, q_lora_rank=48,
               kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
               v_head_dim=16, intermediate_size=96, moe_intermediate_size=32,
               num_experts_per_tok=4, num_hidden_layers=3,
               n_routed_experts=8, experts_offset=8, vocab_size=128)
    cfg["rope_scaling"]["original_max_position_embeddings"] = 64
    cfg["published"] = {"num_hidden_layers": 3, "n_routed_experts": 16}
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from repro_torch.configs import kimi_k2_instruct
    from repro_torch.models import api
    api.register(kimi_k2_instruct.smoke_config())
    r = smoke.make_root(tmp_path_factory.mktemp("root"))
    cfg = kimi_smoke()
    path = "portbench/configs/kimi-smoke.json"
    (r / path).write_text(json.dumps(cfg))
    (r / "portbench" / "traffic" / "prefill-2x12.json").write_text(
        json.dumps({"loop": "closed", "pool": 2, "inputs": {"tokens": {
            "shape": [2, 12], "dtype": "int64", "dist": "randint",
            "low": 0, "high": "vocab_size"}}}))
    (r / "portbench" / "limits" / f"{CELL}.json").write_text(
        json.dumps({"limits": {"logits_rms_rel_err": 0.05,
                               "kv_rms_rel_err": 0.05,
                               "pinned_logits_rms_rel_err": 0.05}}))
    b = json.loads((r / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "kimi-smoke", "source": cfg["source"],
                         "file": path, "reduced": [], "why": "smoke"})
    b["workloads"].append({"name": CELL, "config": "kimi-smoke",
                           "traffic": "prefill-2x12", "chips": 1,
                           "why": "smoke"})
    for m in b["end_to_end"] + b["per_layer"]:
        wl = m.get("workloads")
        if wl is not None and "kimi-k2-w4a8-ep8.prefill-8x2048" in wl:
            wl.append(CELL)
    (r / "BENCHMARK.json").write_text(json.dumps(b))
    return r


def test_a_run_is_correct_and_the_control_is_not(root):
    cell = spec.resolve(root, CELL)
    out = runner.run(cell, 2**31 + 5, 0.3, False, "cpu",
                     time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["logits_rms_rel_err"]["value"] < 0.01
    assert out["checks"]["pinned_logits_rms_rel_err"]["value"] < 0.01
    assert "prefill_tok_s" in out["metrics"]
    low = cell.system.control_outputs(cell, 2**31 + 5, "cpu")
    got = cell.system.check(cell, 2**31 + 5, "cpu", low)
    assert got["logits_rms_rel_err"] > 0.05 or got["kv_rms_rel_err"] > 0.05


FAULTS = ("experts_offset_by_one", "last_layer_experts_offset_by_one",
          "routed_unscaled")


def expert_fault(st, fault: str) -> None:
    """Put a fault confined to the routed experts into a set-up state:
    each held expert's packed weights and scales moved to the next expert
    in every MoE layer (``experts_offset_by_one``) or in the last alone
    (``last_layer_experts_offset_by_one``), or the routed weights left
    without ``routed_scaling_factor`` (``routed_unscaled``)."""
    import torch
    from repro_torch.models.api import build
    moe = st.params["layers"]["moe"]
    if fault == "routed_unscaled":
        cfg = st.model.cfg
        st.model = build(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, routed_scale=1.0)))
        return
    for name in ("wi", "wg", "wo"):
        for leaf in ("w_packed", "w_scale"):
            t = moe[name][leaf]
            if fault == "experts_offset_by_one":
                moe[name][leaf] = torch.roll(t, 1, dims=1)
            else:
                moe[name][leaf] = t.clone()
                moe[name][leaf][-1] = torch.roll(t[-1], 1, dims=0)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_in_the_routed_experts_fails_the_limits(root, fault):
    cell = spec.resolve(root, CELL)
    span = runner.span_factory(False)
    st = cell.system.setup(cell, 2**31 + 7, "cpu", span)
    expert_fault(st, fault)
    for i in range(int(cell.traffic["pool"])):
        cell.system.step(st, i, span)
    got = cell.system.check(cell, 2**31 + 7, "cpu",
                            cell.system.outputs(st))
    assert got["logits_rms_rel_err"] > 0.05, got
    assert got["pinned_logits_rms_rel_err"] > 0.05, got


def test_packed_tree_holds_the_reference_weights(root):
    """Layer 2 (MoE row 1) of the program's tree is the packing of the
    `layer_fp` weights the reference reads."""
    from repro_torch.nn.layers import pack_dense_weights
    cell = spec.resolve(root, CELL)
    st = cell.system.setup(cell, 11, "cpu", runner.span_factory(False))
    fp = cell.system.layer_fp(cell.config, 11, 2, "cpu")
    moe = st.params["layers"]["moe"]
    packed, scale = pack_dense_weights(fp["moe"]["wo"]["w"], 4)
    assert (moe["wo"]["w_packed"][1] == packed).all()
    assert (moe["wo"]["w_scale"][1] == scale).all()
    assert (moe["router_bias"][1] == fp["moe"]["router_bias"]).all()
    assert st.model.cfg.moe.experts_offset == 8
    assert st.model.cfg.moe.experts_held == 8


def test_a_published_number_that_differs_raises(root):
    cell = spec.resolve(root, CELL)
    cfg = dict(cell.config, routed_scaling_factor=2.5)
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        cell.system.port_config(cfg, 8)


def test_the_yardstick_at_the_published_shapes():
    cfg = smoke.real_config("kimi-k2-instruct-w4a8-ep8")
    per_token = work_mla_moe.packed_macs(cfg, 1)
    mla = 7168 * 1536 + 1536 * 12288 + 7168 * 576 + 512 * 16384 \
        + 8192 * 7168
    assert mla == 101_122_048
    swiglu = 3 * 7168 * 2048
    want = 8 * mla + 3 * 7168 * 18432 + 7 * swiglu + 7 * swiglu * 8 * 48 \
        / 384
    assert per_token == pytest.approx(want, rel=1e-12)
    rows = work_mla_moe.expert_rows(cfg, 16384)
    assert rows == pytest.approx(16384 * 8 / 384)
    gemms = work_mla_moe.gemm_work(cfg, 16384)
    assert sum(g["count"] for g in gemms) == 5 * 8 + 3 + 3 * 7 + 3 * 48 * 7
