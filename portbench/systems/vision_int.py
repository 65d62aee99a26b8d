"""The port's integer CNN (`repro_torch.vision`) as the system under test.

Set-up: float weights and calibration batches made on the device from
the seed (by the benchmark, not by the program), the port's
`collect_absmax` over the calibration batches, its uniform plan at the
configuration's w_bits (`launch/vision.py::uniform_plan`), `quantize_net`
on the device, the traffic's pool of waves, two warm-up waves.

A unit of work is one wave: the port's input quantization
(`vision.models.quantize` with the net's input grid, as `quantize_input`
does on a host array), `forward_int`, and the int32 logits copied to
the host. Spans: ``wave.quantize``, ``wave.forward``, ``wave.readback``.

The check runs the plain reference (`reference/vision_int.py`) over
every pool wave and counts the served logits that differ from it, over
every wave of the window.
"""
from __future__ import annotations

import math

import torch

from portbench.harness import traffic as traffic_mod
from portbench.harness import work

WARMUP = 2


def make_fp_params(cfg: dict, seed: int, device) -> dict:
    """He-scaled float weights of every conv and linear layer, BN scale
    about 0.4 and bias about 0, all from one draw on the device."""
    shapes = []
    for tr in work.vision_layers(cfg):
        L, (_, _, c) = tr["layer"], tr["in"]
        if L["kind"] == "conv":
            fh, fw, co = L.get("fh", 3), L.get("fw", 3), L["cout"]
            shapes.append((L["path"], {
                "w": ((fh, fw, c, co), 0.0, math.sqrt(2.0 / (fh * fw * c))),
                "bn_scale": ((co,), 0.4, 0.05),
                "bn_bias": ((co,), 0.0, 0.05)}))
        elif L["kind"] == "linear":
            shapes.append((L["path"], {
                "w": ((c, L["cout"]), 0.0, 1.0 / math.sqrt(c))}))
        elif L["kind"] not in ("add", "avgpool_global"):
            raise ValueError(f"{L['path']}: no weights for {L['kind']!r}")
    total = sum(math.prod(s) for _, leaves in shapes
                for s, _, _ in leaves.values())
    gen = torch.Generator(device=device).manual_seed(
        traffic_mod.sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    params, at = {}, 0
    for path, leaves in shapes:
        node = {}
        for name, (shape, mean, std) in leaves.items():
            n = math.prod(shape)
            node[name] = (flat[at:at + n].reshape(shape) * std + mean)
            at += n
        tree = params
        parts = path.split("/")
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = node
    return params


def make_calibration(cfg: dict, seed: int, device) -> list:
    c = cfg["calibration"]
    gen = torch.Generator(device=device).manual_seed(
        traffic_mod.sub_seed(seed, "calibration"))
    return [torch.rand((c["batch"], cfg["in_h"], cfg["in_w"], cfg["in_ch"]),
                       generator=gen, device=device)
            for _ in range(c["batches"])]


def port_config(cfg: dict):
    from repro_torch.vision.models import LayerDef, VisionConfig
    return VisionConfig(
        name=cfg["name"], layers=tuple(LayerDef(**L) for L in cfg["layers"]),
        num_classes=cfg["num_classes"], in_hw=(cfg["in_h"], cfg["in_w"]),
        in_ch=cfg["in_ch"], a_bits=cfg["a_bits"])


class State:
    pass


def setup(cell, seed: int, device, span):
    from repro_torch.launch.vision import uniform_plan
    from repro_torch.vision import models

    cfg = cell.config
    st = State()
    st.models = models
    vcfg = port_config(cfg)
    fp = make_fp_params(cfg, seed, device)
    calib = [x.cpu().numpy() for x in make_calibration(cfg, seed, device)]
    absmax = models.collect_absmax(vcfg, fp, calib)
    plan = uniform_plan(vcfg, cfg["w_bits"], cfg["a_bits"])
    st.qnet = models.quantize_net(vcfg, fp, absmax, plan=plan,
                                  device=device)
    del fp
    st.pool = traffic_mod.make_pool(cell.traffic, cfg, seed, device)
    st.logits = []
    with torch.inference_mode():
        for i in range(WARMUP):
            step(st, i, span)
    st.logits = []
    return st


def step(st, i: int, span) -> dict:
    slot = i % len(st.pool)
    x = st.pool[slot]["images"]
    with torch.inference_mode():
        with span("wave.quantize"):
            xq = st.models.quantize(x, st.qnet.input_spec)
        with span("wave.forward"):
            y = st.models.forward_int(st.qnet, xq)
        with span("wave.readback"):
            out = y.cpu()
    st.logits.append((slot, out))
    return {"images": int(x.shape[0])}


def outputs(st):
    return {"logits": st.logits}


def reference_logits(cell, seed: int, device, a_bits: int) -> list:
    """The reference's int logits of every pool wave, at ``a_bits``."""
    ref = cell.reference
    cfg = cell.config
    fp = make_fp_params(cfg, seed, device)
    calib = make_calibration(cfg, seed, device)
    pool = traffic_mod.make_pool(cell.traffic, cfg, seed, device)
    with torch.inference_mode():
        net = ref.derive(cfg, fp, calib, a_bits, cfg["w_bits"])
        return [ref.logits(net, b["images"]).cpu() for b in pool]


def compare(served: list, expected: list) -> dict:
    """Every served wave against the reference's logits of its slot."""
    bad = 0
    for slot, out in served:
        bad += int((out.to(torch.int64) != expected[slot]).sum())
    return {"logit_mismatches": bad, "waves_compared": len(served)}


def check(cell, seed: int, device, outs) -> dict:
    expected = reference_logits(cell, seed, device, cell.config["a_bits"])
    return compare(outs["logits"], expected)


def control_outputs(cell, seed: int, device) -> dict:
    """The control: the reference in the program's place, its
    activations at the control's lower precision, one wave per slot."""
    low = reference_logits(cell, seed, device,
                           cell.config["control"]["a_bits"])
    return {"logits": [(i, t) for i, t in enumerate(low)]}
