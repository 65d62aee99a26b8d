"""LM serving launcher: take seeded params (or a checkpoint's,
``--ckpt``), convert them to the packed sub-byte deployment artifact,
and serve a batch of synthetic requests through `Engine` on
``--device`` (default ``cuda``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --quant w4a8 --requests 8 --max-new 16

``--smoke`` takes the arch's reduced same-family config; ``--layers N``
keeps the widths and cuts the depth (llama-3.2-vision-90b's 100 layers
do not fit one card: ``--layers 10`` serves two groups of four self
layers and a cross layer; the MoE archs kimi-k2-1t-a32b and
llama4-maverick-400b-a17b need ``--layers 1``, one layer's routed
experts being 33.8 and 32.2 GB of bfloat16); ``--device cpu`` runs every
dense layer through the kernels' plain versions. The packed tree shares
every float leaf (embeddings, norms, a MoE's router and routed experts)
with the fp tree, so those are made once. The enc-dec and vision archs serve
with their cross cache at zero, as the reference's `Engine` does: no
request carries source embeddings.
Mixed-precision serving: pass a deployment plan (one saved by
``repro.launch.deploy`` loads too) and each dense layer is packed at its
plan-resolved bit-width instead of one uniform ``--quant``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --smoke --plan plan.json --requests 8 --device cpu

``--ckpt DIR`` serves the fp weights of a checkpoint (``state["params"]``
when the tree has it, as a training checkpoint does) in place of seeded
ones; with the plan and checkpoint ``repro_torch.launch.deploy`` wrote,
this serves the deployed artifact:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --ckpt ckpt/ --plan plan.json

``--mesh DP,TP`` serves on a (data=DP, model=TP) mesh (positions share
the host's devices round-robin): the waves' slots split into DP data
blocks, and each block's decode splits over its TP model positions
(heads, MLP columns, experts, recurrence channels and vocab rows; LM
tensor parallelism, `repro_torch.parallel.tp`):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --smoke --quant w4a8 --device cpu --mesh 4,2

With ``REPRO_OBS=1`` the run records a ``serve.generate`` span and
exports a Chrome trace on exit to ``REPRO_OBS_TRACE`` (default
``serve_trace.json``); render it with ``python -m
repro_torch.obs.report``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth, widths kept: n_layers, or this "
                    "many encoder and decoder layers for an enc-dec arch")
    ap.add_argument("--quant", default="off", help="off | w8a8 | w4a8 ...")
    ap.add_argument("--plan", default=None,
                    help="mixed-precision plan JSON; overrides --quant")
    ap.add_argument("--kv-bits", type=int, default=16, choices=[16, 8])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir to load fp params from")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serve on a (data=DP, model=TP) mesh: waves "
                         "sharded over 'data', each block's decode "
                         "tensor-parallel over 'model'")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.deploy.apply import apply_plan, int_skeleton
    from repro_torch.deploy.policy import load_plan
    from repro_torch.device import resolve_device
    from repro_torch.launch.convert import convert_params
    from repro_torch.launch.mesh import mesh_line, parse_mesh
    from repro_torch.models.api import build, get_config, get_smoke_config
    from repro_torch.nn.layers import QuantConfig
    from repro_torch.nn.module import param_bytes
    from repro_torch.obs import trace as obs
    from repro_torch.serve.engine import Engine, Request

    device = resolve_device(args.device)
    mesh = None if args.mesh is None else parse_mesh(args.mesh, device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    cfg = dataclasses.replace(cfg, kv_quant_bits=args.kv_bits)
    if args.layers:
        cfg = dataclasses.replace(cfg, **(
            {"enc_layers": args.layers, "dec_layers": args.layers,
             "n_layers": 2 * args.layers} if cfg.family == "encdec"
            else {"n_layers": args.layers}))
        print(f"{cfg.name}: depth cut to layers={args.layers}, widths kept")
    fp_model = build(cfg)
    if args.ckpt:
        from repro_torch.ckpt.checkpoint import restore
        state, _ = restore(args.ckpt, device=device)
        fp_params = state["params"] if "params" in state else state
    else:
        fp_params = fp_model.init(args.seed, device=device)

    plan = None
    if args.plan:
        plan = load_plan(args.plan)
        qcfg = QuantConfig(mode="int", w_bits=plan.default_w_bits,
                           a_bits=plan.default_a_bits)
        model = build(dataclasses.replace(cfg, quant=qcfg, quant_plan=plan))
        params = apply_plan(int_skeleton(model.defs()), fp_params, plan,
                            plan.default_w_bits)
        mode = f"plan:{args.plan} w_bits={plan.distinct_w_bits()}"
    elif args.quant != "off":
        qcfg = QuantConfig(mode="int", w_bits=int(args.quant[1]),
                           a_bits=int(args.quant[3]))
        model = build(dataclasses.replace(cfg, quant=qcfg))
        params = convert_params(int_skeleton(model.defs()), fp_params,
                                qcfg.w_bits)
        mode = args.quant
    else:
        model, params = fp_model, fp_params
        mode = "off"
    del fp_params
    pbytes = param_bytes(params)
    print(f"{cfg.name} [{mode}] params {pbytes / 2**20:.1f} MiB "
          f"({pbytes:,} bytes)")

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=rng.integers(2, cfg.vocab, size=(
        int(rng.integers(2, 8)),)).astype(np.int32),
        max_new_tokens=args.max_new) for _ in range(args.requests)]
    eng = Engine(model, params, batch_size=args.batch, max_len=args.max_len,
                 plan=plan, device=device, mesh=mesh)
    if mesh is not None:
        tpl = ("" if mesh.shape["model"] == 1 else
               ", each block's decode tensor-parallel over 'model'")
        print(f"mesh: {mesh_line(mesh)}; waves sharded over 'data'{tpl}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU, the kernels' plain versions")
    t0 = time.perf_counter()
    with obs.span("serve.generate", cat="serve", requests=len(reqs),
                  batch=args.batch):
        out = eng.generate(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in out)
    print(f"{toks} tokens / {dt:.2f}s = {toks / dt:.1f} tok/s ({where})")
    rep = eng.utilization_report()
    lat = rep["latency_us"]
    if lat is not None:
        qd = rep["queue_depth"]
        print(f"wave latency: p50={lat['p50'] / 1e3:.1f}ms "
              f"p95={lat['p95'] / 1e3:.1f}ms p99={lat['p99'] / 1e3:.1f}ms "
              f"over {lat['waves']} wave(s); queue depth mean "
              f"{qd['mean']:.1f} max {qd['max']}")
    if mesh is not None:
        per = " ".join(f"d{d}={u:.0%}" for d, u in
                       enumerate(rep["per_device"]))
        print(f"cluster utilization: {rep['mean_util']:.0%} over "
              f"{rep['waves']} wave(s) [{per}] — idle devices == padded "
              "slots")
    for r in out[:3]:
        print("  prompt", r.prompt.tolist(), "->", r.out.tolist())
    trace_path = obs.export_if_configured("serve_trace.json")
    if trace_path:
        print(f"trace -> {trace_path} (render: python -m "
              "repro_torch.obs.report)")
    return out


if __name__ == "__main__":
    main()
