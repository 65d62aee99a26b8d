"""Vision deployment launcher: calibrate -> plan -> pack -> serve a CNN.

    PYTHONPATH=src python -m repro_torch.launch.vision --net qat-cnn \
        --bits 8,4,2 --budget auto --out vplan.json --requests 256 \
        --batch 64

builds the net from seeded fp params and calibrates it on seeded random
images. One ``--bits`` width is the uniform plan at that width; two or
more run the calibrator and the per-layer planner (`plan_mixed_precision`
at ``--budget``, ``auto`` by default) and save the plan to ``--out``.
``--from-plan`` loads a plan JSON instead (one saved by the reference
loads too; a channel-group plan with segments comes in this way). The
net is packed and served through `VisionEngine` on ``--device`` (default
``cuda``). ``--mesh DP,TP`` serves the waves on a (data=DP, model=TP)
cluster mesh: images data-parallel, conv and linear output channels
tensor-parallel; on one card every position shares it:

    PYTHONPATH=src python -m repro_torch.launch.vision --net resnet8 \
        --smoke --device cpu --mesh 2,2

With ``REPRO_OBS=1`` the run records spans (``deploy.calibrate``,
``deploy.plan``, ``deploy.pack``, ``serve.generate``), the kernels'
dispatch events and op counters, and exports a Chrome trace on exit to
``REPRO_OBS_TRACE`` (default ``vision_trace.json``); render it with
``python -m repro_torch.obs.report``.
"""
from __future__ import annotations

import argparse


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
                    help="vision config name (repro_torch.vision.configs): "
                         "resnet8, mobilenet-tiny or qat-cnn")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--a-bits", type=int, default=8,
                    help="activation bits at every layer boundary")
    ap.add_argument("--bits", default="8",
                    help="candidate w_bits, widest first; one width builds "
                         "the uniform plan")
    ap.add_argument("--budget", default="auto",
                    help="planner sensitivity budget (a float or 'auto')")
    ap.add_argument("--backend", default=None,
                    help="backend the plan's rules name (cuda | torch); "
                         "must match --device")
    ap.add_argument("--from-plan", default=None,
                    help="existing plan JSON: skip calibrate/search")
    ap.add_argument("--out", default="vision_plan.json",
                    help="where a searched plan is saved")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--calib-batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serve on a (data=DP, model=TP) mesh; positions "
                         "share the host's devices round-robin")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.deploy.calibrate import calibrate_vision
    from repro_torch.deploy.planner import auto_budget, plan_mixed_precision
    from repro_torch.deploy.policy import load_plan, save_plan
    from repro_torch.device import resolve_device
    from repro_torch.kernels.api import check_backend
    from repro_torch.launch.mesh import mesh_line, parse_mesh
    from repro_torch.obs import trace as obs
    from repro_torch.serve.engine import VisionEngine
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import (collect_absmax, init_fp,
                                           quantize_net,
                                           vision_artifact_bytes)

    device = resolve_device(args.device)
    check_backend(args.backend, device)
    mesh = None if args.mesh is None else parse_mesh(args.mesh, device)
    cfg = get_vision_config(args.net, smoke=args.smoke, a_bits=args.a_bits)
    candidates = tuple(int(b) for b in args.bits.split(","))
    rng = np.random.default_rng(args.seed)
    fp_params = init_fp(cfg, seed=args.seed, device=device)
    batches = [rng.uniform(0, 1, size=(
        args.calib_batch, *cfg.in_hw, cfg.in_ch)).astype(np.float32)
        for _ in range(args.calib_batches)]
    if args.from_plan:
        plan = load_plan(args.from_plan)
        absmax = collect_absmax(cfg, fp_params, batches)
        print(f"loaded plan {args.from_plan} ({len(plan.rules)} rules, "
              f"w_bits {plan.distinct_w_bits()})")
    elif len(candidates) == 1:
        absmax = collect_absmax(cfg, fp_params, batches)
        plan = uniform_plan(cfg, candidates[0], args.a_bits, args.backend)
    else:
        print(f"calibrating {cfg.name}: {len(batches)} batches of "
              f"{args.calib_batch} images {cfg.in_hw}, "
              f"candidates W{candidates}")
        with obs.span("deploy.calibrate", cat="deploy", arch=cfg.name,
                      batches=len(batches), candidates=candidates):
            stats, absmax = calibrate_vision(cfg, fp_params, batches,
                                             bits=candidates,
                                             a_bits=args.a_bits)
        with obs.span("deploy.plan", cat="deploy", arch=cfg.name,
                      paths=len(stats)):
            budget = (auto_budget(stats, candidates)
                      if args.budget == "auto" else float(args.budget))
            plan = plan_mixed_precision(
                stats, budget, candidates=candidates, a_bits=args.a_bits,
                backend=args.backend,
                meta={"arch": cfg.name, "smoke": args.smoke})
        for r in plan.rules:
            st = stats[r.pattern]
            sens = ", ".join(f"{b}:{st.sens(b):.2e}" for b in candidates)
            print(f"  {r.pattern:<16} W{r.w_bits}A{r.a_bits}  "
                  f"absmax={st.a_absmax:.3f}  sens={{{sens}}}")
        save_plan(plan, args.out)
        print(f"plan ({len(plan.rules)} rules, w_bits "
              f"{plan.distinct_w_bits()}) -> {args.out}")
    with obs.span("deploy.pack", cat="deploy", arch=cfg.name,
                  rules=len(plan.rules)):
        qnet = quantize_net(cfg, fp_params, absmax, plan=plan,
                            device=device)
    print(f"packed artifact: {vision_artifact_bytes(qnet):,} bytes, "
          f"per-layer bits {qnet.layer_bits()}")

    engine = VisionEngine(qnet, batch_size=args.batch, device=device,
                          mesh=mesh)
    if mesh is not None:
        print(f"mesh: {mesh_line(mesh)}")
    images = rng.uniform(0, 1, size=(
        args.requests, *cfg.in_hw, cfg.in_ch)).astype(np.float32)
    with obs.span("serve.generate", cat="serve", requests=len(images),
                  batch=args.batch):
        logits = engine.run(images)
    print(f"served {len(images)} images in waves of {args.batch} on "
          f"{device}: preds {logits.argmax(-1).tolist()}")
    rep = engine.utilization_report()
    lat = rep["latency_us"]
    if lat is not None:
        print(f"wave latency: p50={lat['p50'] / 1e3:.3f}ms "
              f"p95={lat['p95'] / 1e3:.3f}ms over {lat['waves']} wave(s)")
    if mesh is not None:
        print(f"utilization: mean {rep['mean_util']:.3f} over "
              f"{rep['waves']} waves, per-device "
              f"{[round(u, 3) for u in rep['per_device']]}")
    trace_path = obs.export_if_configured("vision_trace.json")
    if trace_path:
        print(f"trace -> {trace_path} (render: python -m "
              "repro_torch.obs.report)")
    print("vision deploy done")
    return logits


if __name__ == "__main__":
    main()
