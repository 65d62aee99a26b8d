"""QAT deployment launcher: train -> calibrate -> plan -> pack -> evaluate.

Closes the quantization-aware loop on labeled data: fake-quant training
(`repro_torch.qat`), task-loss calibration of the trained weights, a
mixed-precision plan against the measured loss degradation (channel-group
granularity), the folded integer artifact, and integer-path accuracy for
the uniform and the planned deployments side by side:

    PYTHONPATH=src python -m repro_torch.launch.qat --smoke --steps 60 \\
        --device cpu --out qat_plan.json --report qat_accuracy.json

On the card (the default ``--device cuda``) training runs through
autograd and the evaluation through the Hopper kernels:

    PYTHONPATH=src python -m repro_torch.launch.qat --steps 300

``--from-ckpt DIR`` resumes training from a checkpoint (the state
``--ckpt-dir`` saves every ``ckpt_every`` steps; one the reference saved
loads too); ``--w-bits`` picks the uniform training width (0: float
training); ``--mesh DP`` splits each training batch over DP data
positions; ``--dataset mnist --data-dir DIR`` reads the IDX files there.
The report JSON is a per-run record.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="qat-cnn",
                    help="vision config name (repro_torch.vision.configs)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-size net")
    ap.add_argument("--dataset", default="synthetic",
                    choices=("synthetic", "mnist"))
    ap.add_argument("--data-dir", default=None,
                    help="IDX directory for --dataset mnist")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--w-bits", type=int, default=4,
                    help="uniform QAT width (0 = float training)")
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--learned-absmax", action="store_true",
                    help="PACT learned activation ranges instead of EMA")
    ap.add_argument("--bits", default="8,4,2",
                    help="plan candidate widths, widest first")
    ap.add_argument("--budget-frac", type=float, default=0.35)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--eval-batch", type=int, default=100)
    ap.add_argument("--mesh", default=None, metavar="DP",
                    help="split training batches over DP data positions")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the whole training state here")
    ap.add_argument("--from-ckpt", default=None,
                    help="resume training from this checkpoint dir")
    ap.add_argument("--out", default="qat_plan.json",
                    help="plan artifact (deploy.policy schema)")
    ap.add_argument("--report", default="qat_accuracy.json",
                    help="accuracy run record")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    # heavy imports after argparse so --help stays instant
    import json

    import numpy as np

    from repro_torch.deploy.calibrate import calibrate_vision
    from repro_torch.deploy.planner import (auto_budget,
                                            plan_mixed_precision)
    from repro_torch.deploy.policy import save_plan
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.obs import trace as obs
    from repro_torch.qat.data import make_dataset
    from repro_torch.qat.evaluate import deploy, evaluate_int, fold_check
    from repro_torch.qat.train import QATConfig, train_qat
    from repro_torch.vision.configs import get_vision_config
    from repro_torch.vision.models import streamed_weight_bytes

    dev = resolve_device(args.device)
    cfg = get_vision_config(args.net, smoke=args.smoke, a_bits=args.a_bits)
    data = make_dataset(args.dataset, split="train", seed=args.seed,
                        data_dir=args.data_dir)
    test = make_dataset(args.dataset, split="test", seed=args.seed,
                        data_dir=args.data_dir)
    candidates = tuple(int(b) for b in args.bits.split(","))
    mesh = (make_cluster_mesh(int(args.mesh.split(",")[0]), 1, dev)
            if args.mesh else None)

    qc = QATConfig(steps=args.steps, batch=args.batch, lr=args.lr,
                   warmup=args.warmup,
                   w_bits=(args.w_bits or None), a_bits=args.a_bits,
                   learned_absmax=args.learned_absmax, seed=args.seed,
                   log_every=max(args.steps // 5, 1))
    with obs.span("launch.qat", cat="qat", net=cfg.name,
                  steps=args.steps, w_bits=args.w_bits):
        result = train_qat(cfg, data, qc, mesh=mesh, ckpt_dir=args.ckpt_dir,
                           from_ckpt=args.from_ckpt, device=dev)
        print(f"# trained {cfg.name}: "
              + " ".join(f"step{r['step']}={r['loss']:.3f}"
                         for r in result.log), flush=True)
        if args.w_bits:
            fold_check(result)
            print("# fold_check: weight grids fold bit-exact", flush=True)

        # task-loss calibration on the trained weights
        xs, ys = [], []
        for x, y in data.batches(args.batch, args.calib_batches):
            xs.append(np.asarray(x))
            ys.append(np.asarray(y))
        stats, _ = calibrate_vision(cfg, result.model_params(), xs,
                                    sensitivity="task_loss", labels=ys,
                                    a_bits=args.a_bits, bits=candidates)
        budget = auto_budget(stats, candidates, frac=args.budget_frac)
        plan = plan_mixed_precision(
            stats, budget, candidates=candidates, a_bits=args.a_bits,
            meta={"source": "task_loss", "net": cfg.name},
            granularity="channel_group")
        print(f"# plan (budget={budget:.4f}): "
              f"{ {r.pattern: r.w_bits for r in plan.rules} }", flush=True)
        save_plan(plan, args.out)
        print(f"# wrote plan -> {args.out}", flush=True)

        rows = []
        deployments = [("uniform", None)] if not args.w_bits else \
            [(f"uniform_w{args.w_bits}", None)]
        deployments.append(("task_loss_plan", plan))
        for tag, p in deployments:
            qnet = deploy(result, plan=p, device=dev)
            ev = evaluate_int(qnet, test.batches(args.eval_batch,
                                                 args.eval_batches))
            row = {"deployment": tag,
                   "accuracy": round(float(ev["accuracy"]), 6),
                   "correct": int(ev["correct"]), "n": int(ev["n"]),
                   "packed_weight_bytes": int(streamed_weight_bytes(qnet))}
            rows.append(row)
            print(f"# {tag}: acc={row['accuracy']:.4f} "
                  f"bytes={row['packed_weight_bytes']}", flush=True)

    report = {"net": cfg.name, "dataset": args.dataset,
              "device": str(dev),
              "train": {"steps": args.steps, "w_bits": args.w_bits,
                        "a_bits": args.a_bits, "seed": args.seed,
                        "final_loss": result.log[-1]["loss"]
                        if result.log else None},
              "budget": budget, "rows": rows}
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote report -> {args.report}", flush=True)
    return {"result": result, "plan": plan, "rows": rows, "budget": budget}


if __name__ == "__main__":
    main()
