"""Mixed-precision LM deployment launcher: calibrate -> plan -> pack ->
save, on ``--device`` (default ``cuda``).

Turns an fp checkpoint (``--ckpt``; without it, seeded params) into a
per-layer W{8,4,2} packed serving artifact plus the JSON plan that
describes it:

    PYTHONPATH=src python -m repro_torch.launch.deploy --arch qwen2.5-3b \
        --ckpt ckpt/ --budget auto --out plan.json --artifact art/

The plan is then served with ``python -m repro_torch.launch.serve ...
--ckpt ckpt/ --plan plan.json``. The plan and the artifact are the
reference's (`repro.launch.deploy`) byte for byte: either package's
``serve`` reads them.

``--from-plan old_plan.json`` skips calibration and the search and
re-packs from an existing plan (schema v1-v4), re-saving it to ``--out``
in the current schema; a v1 rule's ``use_kernel`` pins one of the
reference's backends, which the port refuses.

With ``REPRO_OBS=1`` the run records the ``deploy.calibrate``,
``deploy.plan`` and ``deploy.pack`` spans and exports a Chrome trace on
exit to ``REPRO_OBS_TRACE`` (default ``deploy_trace.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def calib_batches(vocab: int, n: int = 2, batch: int = 2, seq: int = 32,
                  seed: int = 0):
    """The CLI's calibration batches: ``n`` (batch, seq) int32 token
    arrays in [2, vocab) from ``np.random.default_rng(seed)``, as the
    reference draws them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=(batch, seq)).astype(np.int32)
            for _ in range(n)]


def main(argv=None):
    """Run the CLI; returns a summary: the plan, ``fp_bytes``,
    ``mixed_bytes`` (and ``w8_bytes`` when the plan accounts for them),
    and when it calibrated, ``stats``, ``budget`` and ``calibrate_s``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--budget", default="auto",
                    help="total sensitivity budget (float) or 'auto'")
    ap.add_argument("--bits", default="8,4,2",
                    help="candidate w_bits, widest first")
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--backend", default=None,
                    help="backend the plan rules name ('cuda' | 'torch'; "
                         "default: whatever the serving device runs)")
    ap.add_argument("--from-plan", default=None,
                    help="existing plan JSON: skip calibrate/search, "
                         "re-save to --out in the current schema, and pack")
    ap.add_argument("--calib-batches", type=int, default=2)
    ap.add_argument("--calib-batch", type=int, default=2)
    ap.add_argument("--calib-seq", type=int, default=32)
    ap.add_argument("--out", default="plan.json")
    ap.add_argument("--artifact", default=None,
                    help="directory to save the packed param tree into")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir to load fp params from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.calibrate import calibrate
    from repro_torch.deploy.planner import auto_budget, plan_mixed_precision
    from repro_torch.deploy.policy import PLAN_VERSION, load_plan, save_plan
    from repro_torch.device import resolve_device
    from repro_torch.launch.convert import artifact_bytes
    from repro_torch.models.api import build, get_config, get_smoke_config
    from repro_torch.nn.layers import QuantConfig
    from repro_torch.obs import trace as obs

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    candidates = tuple(int(b) for b in args.bits.split(","))

    fp_model = build(cfg)
    if args.ckpt:
        from repro_torch.ckpt.checkpoint import restore
        state, _ = restore(args.ckpt, device=device)
        fp_params = state["params"] if "params" in state else state
    else:
        fp_params = fp_model.init(args.seed, device=device)

    summary = {}
    if args.from_plan:
        ignored = [f for f, dflt in (("--backend", None), ("--bits", "8,4,2"),
                                     ("--budget", "auto"), ("--a-bits", 8))
                   if getattr(args, f.lstrip("-").replace("-", "_")) != dflt]
        if ignored:
            print(f"warning: {', '.join(ignored)} ignored with --from-plan "
                  "(the existing plan's rules are kept verbatim)")
        plan = load_plan(args.from_plan)
        save_plan(plan, args.out)
        print(f"re-saved plan {args.from_plan} -> {args.out} "
              f"(schema v{PLAN_VERSION}, {len(plan.rules)} rules, "
              f"w_bits {plan.distinct_w_bits()}, backends "
              f"{sorted({r.backend for r in plan.rules}, key=str)})")
    else:
        batches = calib_batches(cfg.vocab, args.calib_batches,
                                args.calib_batch, args.calib_seq, args.seed)
        print(f"calibrating {cfg.name}: {len(batches)} batches of "
              f"{args.calib_batch}x{args.calib_seq} tokens, "
              f"candidates W{candidates}")
        t0 = time.perf_counter()
        with obs.span("deploy.calibrate", cat="deploy", arch=cfg.name,
                      batches=len(batches), candidates=candidates):
            stats = calibrate(fp_model, fp_params, batches, bits=candidates,
                              a_bits=args.a_bits)
        summary["calibrate_s"] = time.perf_counter() - t0

        with obs.span("deploy.plan", cat="deploy", arch=cfg.name,
                      paths=len(stats)):
            budget = (auto_budget(stats, candidates)
                      if args.budget == "auto" else float(args.budget))
            plan = plan_mixed_precision(
                stats, budget, candidates=candidates, a_bits=args.a_bits,
                backend=args.backend,
                meta={"arch": cfg.name, "smoke": args.smoke})
        print(f"budget {budget:.6g} -> total sensitivity "
              f"{plan.meta['total_sensitivity']:.6g}")
        for r in plan.rules:
            st = stats[r.pattern]
            print(f"  {r.pattern:<28} W{r.w_bits}A{r.a_bits}  "
                  f"absmax={st.a_absmax:.3f}  "
                  f"sens={{{', '.join(f'{b}:{st.sens(b):.2e}' for b in candidates)}}}")
        save_plan(plan, args.out)
        print(f"plan ({len(plan.rules)} rules, w_bits "
              f"{plan.distinct_w_bits()}) -> {args.out}")
        summary.update(stats=stats, budget=budget)

    base = QuantConfig(mode="int", w_bits=plan.default_w_bits,
                       a_bits=plan.default_a_bits)
    q_model = build(dataclasses.replace(cfg, quant=base, quant_plan=plan))
    with obs.span("deploy.pack", cat="deploy", arch=cfg.name,
                  rules=len(plan.rules)):
        # onto the int skeleton: the float leaves are the fp tree's own
        q_params = apply_plan(int_skeleton(q_model.defs()), fp_params, plan,
                              plan.default_w_bits)
    mixed_b = artifact_bytes(q_params)
    fp_b = artifact_bytes(fp_params)
    summary.update(plan=plan, fp_bytes=fp_b, mixed_bytes=mixed_b)
    if {"packed_weight_bytes", "uniform_w8_bytes"} <= set(plan.meta):
        # the non-dense remainder (embeddings, norms, biases) is the same
        # in both artifacts; only the planner-accounted dense bytes differ
        w8_b = (mixed_b - plan.meta["packed_weight_bytes"]
                + plan.meta["uniform_w8_bytes"])
        summary["w8_bytes"] = w8_b
        print(f"artifact bytes: fp {fp_b:,}  uniform-w8 {w8_b:,}  "
              f"mixed {mixed_b:,}  ({mixed_b / w8_b:.3f}x of w8)")
    else:  # hand-written or stripped-meta plans (--from-plan)
        print(f"artifact bytes: fp {fp_b:,}  mixed {mixed_b:,}")

    if args.artifact:
        from repro_torch.ckpt.checkpoint import save
        save(args.artifact, 0, {"params": q_params})
        save_plan(plan, f"{args.artifact}/plan.json")
        print(f"packed artifact -> {args.artifact}")
    trace_path = obs.export_if_configured("deploy_trace.json")
    if trace_path:
        print(f"trace -> {trace_path} (render: python -m "
              "repro_torch.obs.report)")
    print("deploy done")
    return summary


if __name__ == "__main__":
    main()
