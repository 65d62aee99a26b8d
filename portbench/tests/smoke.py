"""A checkout-like root holding the benchmark at smoke sizes: the real
``portbench/`` copied, plus configurations, traffic, limits and cells of
their own, added as files alone (the way a later change adds a cell)."""
from __future__ import annotations

import copy
import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

VISION = "resnet8-smoke.frames-8"
LM = "phi3-smoke.prefill-2x16"


def real_config(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def resnet8_smoke() -> dict:
    """The ResNet-8 graph at widths 8/16/32 on 16x16 images."""
    cfg = real_config("resnet8-w4a8")
    cfg["name"] = "resnet8-smoke"
    cfg["in_h"] = cfg["in_w"] = 16
    cfg["calibration"] = {"batches": 2, "batch": 8}
    for L in cfg["layers"]:
        if L["kind"] == "conv":
            L["cout"] //= 2
    return cfg


def phi3_smoke() -> dict:
    cfg = real_config("phi3-mini-3.8b-w4a8")
    cfg.update(name="phi3-smoke", hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=4, vocab_size=120, sliding_window=11)
    return cfg


def make_root(tmp: pathlib.Path, limits=None) -> pathlib.Path:
    """``tmp`` as a root with the two smoke cells; ``limits`` overrides
    a cell's limits file."""
    tmp = pathlib.Path(tmp)
    shutil.copytree(BENCH, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(ROOT / "BENCHMARK.json") as f:
        b = json.load(f)
    b = copy.deepcopy(b)
    for cfg in (resnet8_smoke(), phi3_smoke()):
        path = f"portbench/configs/{cfg['name']}.json"
        (tmp / path).write_text(json.dumps(cfg))
        b["configs"].append({"name": cfg["name"], "source": cfg["source"],
                             "file": path, "reduced": [], "why": "smoke"})
    traffic = {
        "frames-8": {"loop": "closed", "pool": 2, "inputs": {"images": {
            "shape": [8, "in_h", "in_w", "in_ch"], "dtype": "float32",
            "dist": "uniform", "low": 0.0, "high": 1.0}}},
        "prefill-2x16": {"loop": "closed", "pool": 2, "inputs": {"tokens": {
            "shape": [2, 16], "dtype": "int64", "dist": "randint",
            "low": 0, "high": "vocab_size"}}}}
    for name, t in traffic.items():
        (tmp / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    lims = {VISION: {"logit_mismatches": 0},
            LM: {"logits_rel_err": 0.05, "kv_rel_err": 0.05}}
    lims.update(limits or {})
    for cell, lim in lims.items():
        (tmp / "portbench" / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": lim}))
    b["workloads"] += [
        {"name": VISION, "config": "resnet8-smoke", "traffic": "frames-8",
         "chips": 1, "why": "smoke"},
        {"name": LM, "config": "phi3-smoke", "traffic": "prefill-2x16",
         "chips": 1, "why": "smoke"}]
    for m in b["end_to_end"] + b["per_layer"]:
        wl = m.get("workloads")
        if wl is not None:
            if any(w.startswith("resnet8") for w in wl):
                wl.append(VISION)
            if any(w.startswith("phi3") for w in wl):
                wl.append(LM)
    (tmp / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return tmp
