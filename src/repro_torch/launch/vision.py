"""Vision deployment launcher: calibrate -> plan -> pack -> serve a CNN.

    PYTHONPATH=src python -m repro_torch.launch.vision --net resnet8 \
        --bits 4 --requests 256 --batch 64

builds the net from seeded fp params, calibrates activation ranges on
seeded random images, quantizes it at one weight width (a single ``--bits``
value is the uniform plan; two or more need the deploy planner, which is
not ported yet), and serves a batch of images through `VisionEngine` on
``--device`` (default ``cuda``). ``--from-plan`` loads a plan JSON
(including one saved by the reference) instead.
"""
from __future__ import annotations

import argparse

# Calibration pass of the reference launcher's defaults.
CALIB_BATCHES, CALIB_BATCH = 2, 4


def uniform_plan(cfg, w_bits: int, a_bits: int, backend=None,
                 pipeline=None):
    """One rule per plan-addressable layer at ``w_bits``: the plan the
    reference planner returns for a single candidate width."""
    from repro_torch.deploy.policy import PlanRule, PrecisionPlan
    from repro_torch.vision.models import COMPUTE_KINDS

    rules = tuple(
        PlanRule(pattern=L.path, w_bits=w_bits, a_bits=a_bits,
                 backend=backend, pipeline=pipeline)
        for L in sorted(cfg.layers, key=lambda L: L.path)
        if L.kind in COMPUTE_KINDS)
    return PrecisionPlan(rules=rules, default_w_bits=w_bits,
                         default_a_bits=a_bits)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", required=True,
                    help="vision config name (repro_torch.vision.configs)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--a-bits", type=int, default=8,
                    help="activation bits at every layer boundary")
    ap.add_argument("--bits", default="8",
                    help="weight bits; one width builds the uniform plan")
    ap.add_argument("--backend", default=None,
                    help="op backend (cuda | torch; default: by device)")
    ap.add_argument("--from-plan", default=None,
                    help="existing plan JSON: skip planning")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.deploy.policy import load_plan
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (collect_absmax, init_fp,
                                           quantize_net,
                                           vision_artifact_bytes)

    device = resolve_device(args.device)
    cfg = get_vision_config(args.net, smoke=args.smoke, a_bits=args.a_bits)
    rng = np.random.default_rng(args.seed)
    fp_params = init_fp(cfg, seed=args.seed, device=device)
    batches = [rng.uniform(0, 1, size=(
        CALIB_BATCH, *cfg.in_hw, cfg.in_ch)).astype(np.float32)
        for _ in range(CALIB_BATCHES)]
    absmax = collect_absmax(cfg, fp_params, batches)
    if args.from_plan:
        plan = load_plan(args.from_plan)
        print(f"loaded plan {args.from_plan} ({len(plan.rules)} rules, "
              f"w_bits {plan.distinct_w_bits()})")
    else:
        widths = tuple(int(b) for b in args.bits.split(","))
        if len(widths) != 1:
            raise NotImplementedError(
                f"--bits {args.bits}: choosing among several widths needs "
                "the deploy planner and calibrator, which are not ported "
                "yet (ROADMAP Queue 1, item 7); pass one width")
        plan = uniform_plan(cfg, widths[0], args.a_bits, args.backend)
    qnet = quantize_net(cfg, fp_params, absmax, plan=plan,
                        backend=args.backend, device=device)
    print(f"packed artifact: {vision_artifact_bytes(qnet):,} bytes, "
          f"per-layer bits {qnet.layer_bits()}")

    engine = VisionEngine(qnet, batch_size=args.batch, backend=args.backend,
                          device=device)
    images = rng.uniform(0, 1, size=(
        args.requests, *cfg.in_hw, cfg.in_ch)).astype(np.float32)
    logits = engine.run(images)
    print(f"served {len(images)} images in waves of {args.batch} on "
          f"{device}: preds {logits.argmax(-1).tolist()}")
    lat = engine.utilization_report()["latency_us"]
    if lat is not None:
        print(f"wave latency: p50={lat['p50'] / 1e3:.3f}ms "
              f"p95={lat['p95'] / 1e3:.3f}ms over {lat['waves']} wave(s)")
    print("vision deploy done")
    return logits


if __name__ == "__main__":
    main()
