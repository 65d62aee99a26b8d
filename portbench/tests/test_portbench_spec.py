"""BENCHMARK.json against the contract's shape, and cells resolved by
name, a smoke cell and a metric added from files alone."""
import json
import re

import pytest

import smoke
from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(smoke.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_benchmark_json_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (smoke.ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200 and len(c["reduced"]) <= 16
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell,e2e,per", [
    ("resnet8-w4a8.frames-16384",
     ["setup_s", "images_per_s", "wave_p95_ms"],
     ["mfu.vision", "qconv_roofline.vision", "idle_share.vision"]),
    ("phi3-mini-w4a8.prefill-8x2048", ["setup_s", "prefill_tok_s"],
     ["mfu.prefill", "qmatmul_roofline.prefill", "idle_share.prefill"]),
])
def test_cells_resolve_by_name(cell, e2e, per):
    c = spec.resolve(smoke.ROOT, cell)
    assert [m.name for m in c.end_to_end] == e2e
    assert [m.name for m in c.per_layer] == per
    assert c.chips == 1 and "limits" in c.limits
    for name in ("setup", "step", "outputs", "check", "control_outputs"):
        assert callable(getattr(c.system, name))


def test_cell_and_metric_added_from_files_alone(tmp_path):
    root = smoke.make_root(tmp_path)
    # every file the benchmark had is there as it was
    for f in smoke.BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            rel = f.relative_to(smoke.BENCH)
            assert (root / "portbench" / rel).read_bytes() == f.read_bytes()
    (root / "portbench" / "metrics" / "waves.vision.py").write_text(
        "def read(ctx):\n    return len(ctx['steps'])\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "waves.vision", "unit": "waves",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "images_per_s",
                           "workloads": [smoke.VISION]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = spec.resolve(root, smoke.VISION)
    assert c.config["name"] == "resnet8-smoke"
    assert [m.name for m in c.per_layer][-1] == "waves.vision"
    assert c.per_layer[-1].reader.read({"steps": [1, 2, 3]}) == 3
    lm = spec.resolve(root, smoke.LM)
    assert lm.config["hidden_size"] == 64
    assert "waves.vision" not in [m.name for m in lm.per_layer]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve(smoke.ROOT, "no-such-cell")


def test_resnet8_graph_is_the_ports():
    from repro_torch.vision.configs.resnet8 import resnet8
    c = spec.resolve(smoke.ROOT, "resnet8-w4a8.frames-16384")
    assert c.system.port_config(c.config).layers == resnet8().layers
