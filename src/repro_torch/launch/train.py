"""Training launcher: config-driven, fault-tolerant, mesh-aware.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 200 --batch 8 --seq 256 --ckpt build/ckpt_olmo

trains on the card (``--device cuda``, the default) from seeded random
weights on the deterministic synthetic token stream; on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --smoke --steps 4 --batch 2 --seq 16 --device cpu --ckpt DIR

``--mesh host`` splits each batch over the host's devices (a data axis
of one position per card). ``pod`` and ``multipod`` build the reference's
production meshes (`launch.mesh.make_production_mesh`), one card per
position: 256 or 512 cards, and a host with fewer exits saying so (the
dry run, ``python -m repro_torch.launch.dryrun``, builds them on
``meta``). Checkpoints
are atomic and asynchronous; re-running the same command resumes from
the latest one, its batches replayed from that step. ``--qat wXaY``
trains with the dense layers' fake-quant forward at W{X} A{Y};
``--opt-state-bits 8`` keeps AdamW's m and v in int8.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for this arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod", "multipod"])
    ap.add_argument("--ckpt", default="repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--qat", default=None,
                    help="fake-quant bits for QAT, e.g. w4a8")
    ap.add_argument("--opt-state-bits", type=int, default=32,
                    choices=[32, 8])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.api import build, get_config, get_smoke_config
    from repro_torch.nn.layers import QuantConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainStepConfig, make_train_fns

    mesh = None
    if args.mesh != "host":   # the device count decides before the device
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "multipod",
                                        device=args.device)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.qat:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(
            mode="fake", w_bits=int(args.qat[1]), a_bits=int(args.qat[3])))

    model = build(cfg)
    if mesh is None:
        mesh = make_host_mesh(device=dev)
        if mesh.size == 1:
            mesh = None   # one position: the batch stays whole
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainStepConfig(opt=OptConfig(
        lr=args.lr, warmup=args.warmup, total_steps=args.steps,
        state_bits=args.opt_state_bits))
    init_fn, step, _ = make_train_fns(model, mesh, shape, tcfg, device=dev)
    data = SyntheticLM(
        cfg.vocab, args.batch, args.seq, seed=args.seed, device=dev,
        mesh=mesh,
        src_dim=cfg.d_model if (cfg.family == "encdec" or cfg.cross_every)
        else 0,
        src_len=args.seq if cfg.family == "encdec" else cfg.src_len)

    trainer = Trainer(init_fn, step, data, TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt), device=dev)
    state, log = trainer.run(args.seed)
    if trainer.restored_step is not None:
        print(f"resumed at step {trainer.restored_step} from {args.ckpt}",
              flush=True)
    for rec in log[:: max(len(log) // 10, 1)]:
        print(f"step {rec['step']:6d} loss {rec['loss']:.4f} "
              f"gnorm {rec['grad_norm']:.2f} {rec['dt'] * 1e3:.0f} ms",
              flush=True)
    if log:
        print(f"final step {log[-1]['step']} loss {log[-1]['loss']:.4f}; "
              f"stragglers {trainer.monitor.flags}; ckpts at {args.ckpt}",
              flush=True)
    else:
        print(f"nothing to run: the checkpoint in {args.ckpt} is at step "
              f"{trainer.restored_step} of {args.steps}", flush=True)
    return {"state": state, "log": log, "trainer": trainer, "data": data}


if __name__ == "__main__":
    main()
