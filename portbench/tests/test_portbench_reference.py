"""Each plain reference against the port at smoke size on the CPU (the
test imports both; the references import nothing of the port), and the
references' independence."""
import ast
import dataclasses

import numpy as np
import pytest
import torch

import smoke
from portbench.harness import spec, traffic

REF = smoke.BENCH / "reference"


@pytest.mark.parametrize("path", sorted(REF.glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_port(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    assert tops <= {"__future__", "typing", "numpy", "torch", "portbench"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("w_bits", [8, 4, 2])
def test_vision_reference_equals_port(root, w_bits):
    cell = spec.resolve(root, smoke.VISION)
    cfg = dict(cell.config, w_bits=w_bits)
    cell = dataclasses.replace(cell, config=cfg)
    sysm, ref = cell.system, cell.reference
    fp = sysm.make_fp_params(cfg, 5, "cpu")
    calib = sysm.make_calibration(cfg, 5, "cpu")
    images = traffic.make_pool(cell.traffic, cfg, 5, "cpu")[0]["images"]
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.vision import models
    vcfg = sysm.port_config(cfg)
    absmax = models.collect_absmax(vcfg, fp, [c.numpy() for c in calib])
    qnet = models.quantize_net(vcfg, fp, absmax, device="cpu",
                               plan=uniform_plan(vcfg, w_bits, 8))
    got = models.forward_int(qnet, models.quantize(images, qnet.input_spec))
    net = ref.derive(cfg, fp, calib, 8, w_bits)
    want = ref.logits(net, images, block=3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ref.absmax(cfg, fp, calib) == absmax


def test_vision_control_differs(root):
    cell = spec.resolve(root, smoke.VISION)
    a8 = cell.system.reference_logits(cell, 9, "cpu", 8)
    a4 = cell.system.reference_logits(cell, 9, "cpu", 4)
    assert all((x != y).any() for x, y in zip(a8, a4))


def test_decoder_reference_equals_port(root):
    cell = spec.resolve(root, smoke.LM)
    cfg = cell.config
    sysm, ref = cell.system, cell.reference
    from repro_torch.deploy.apply import int_skeleton
    from repro_torch.launch.convert import convert_params
    from repro_torch.models.api import build
    model = build(sysm.port_config(cfg, 8))
    fp = sysm.make_fp_params(cfg, 3, "cpu")
    params = convert_params(int_skeleton(model.defs()), fp, cfg["w_bits"])
    tokens = traffic.make_pool(cell.traffic, cfg, 3, "cpu")[0]["tokens"]
    with torch.inference_mode():
        logits, (k, v) = model.prefill(params, {"tokens": tokens})
    seen = []
    want = ref.last_logits(cfg, fp, tokens, 8,
                           on_layer=lambda i, kk, vv: seen.append((kk, vv)))
    got = logits[:, 0, :cfg["vocab_size"]].to(torch.float32)
    scale = want.abs().amax()
    assert float((got - want).abs().max() / scale) < 1e-2
    for i, (kk, vv) in enumerate(seen):
        assert float((k[i].float() - kk.float()).abs().max()) <= 1e-2 * \
            float(kk.float().abs().max())
        assert float((v[i].float() - vv.float()).abs().max()) <= 1e-2 * \
            float(vv.float().abs().max())
    assert len(seen) == cfg["num_hidden_layers"]


def test_decoder_window_masks_far_keys():
    from portbench.reference import decoder_lm as ref  # noqa: F401
    q = torch.randn(1, 6, 2, 4)
    k = torch.randn(1, 6, 2, 4)
    v = torch.zeros(1, 6, 2, 4)
    v[0, 0] = 1.0                      # only position 0 carries a value
    out = ref.attention(q, k, v, window=3)
    assert float(out[0, 2].abs().sum()) > 0       # 2 - 0 < 3: seen
    assert float(out[0, 3].abs().sum()) == 0      # 3 - 0 = 3: masked
