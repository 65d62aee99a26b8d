"""Multi-pod dry run on torch's ``meta`` device: every (arch x shape) cell
on the reference's production meshes, built through the port's own step
builders, shardings and tensor-parallel placements, with per-position
memory, FLOPs, IO bytes, collective bytes and an H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k --mesh pod            # 16x16, 256 positions
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod

Nothing is allocated and no card is needed: every tensor is ``meta``,
and the step runs eagerly under `repro_torch.launch.costs.Recorder`.
Records go to ``build/dryrun/`` (``--out`` elsewhere); a failure is a
sharding or memory fault of the port.

**The port's placement, per step kind** (``argument``, per position):
- train: the state (params, AdamW m and v, int8 for bf16-param archs as
  the reference keeps them) whole on position 0, the controller's device
  (`train.step.make_train_fns` keeps it there and places each leaf
  inside the forward); the batch's rows over the data blocks;
- prefill and decode: the params placed on each block's model positions
  (`Model.place`, weight-stationary, replicated leaves on the block's
  first position), each block's cache rows placed alike
  (`Model.place_cache`), the tokens' rows over the data blocks.

**One data block.** Every (pod, data) block of a cell has the same
per-position shapes, so the dry run traces one: the cell's ``model``
positions, with the global batch divided by the number of blocks (the
whole batch where it does not divide, which the batch's sharding then
replicates). ``traced_blocks`` says so. Two things of the whole mesh are
reckoned, not traced: for training, the data-parallel gradient sum that
the single controller does implicitly, an ``all-reduce`` of the whole
gradient at the block's first position (the state is replicated over the
blocks); not at all, the controller's concatenation of the blocks'
output rows (logits) at position 0.

The record's per-device figures are the busiest traced position's:
``bytes_per_device`` that of the largest ``total`` (argument + output +
temp, where temp + output is the position's peak of live allocations),
the FLOPs, IO and collective figures and ``roofline`` that of the
largest roofline bound; ``per_position`` has every position's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ShapeConfig, cells_for
from repro_torch.launch import costs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build, get_config, list_archs
from repro_torch.nn.module import leaf_paths
from repro_torch.parallel import tp
from repro_torch.parallel.mesh import (NamedSharding, P, Sharded,
                                       block_entry, data_blocks, device_put,
                                       make_mesh)

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def active_params(model) -> float:
    """N_active for the 6ND rule: MoE counts top_k+shared experts only."""
    cfg = model.cfg
    leaves = leaf_paths(model.defs())
    total = sum(math.prod(d.shape) for _, d in leaves)
    if cfg.moe is None:
        return float(total)
    moe = sum(math.prod(d.shape) for path, d in leaves
              if any(k in ("wi", "wg", "wo") for k in path)
              and "moe" in path and "shared" not in path)
    return float(total - moe + moe * cfg.moe.top_k / cfg.moe.n_experts)


def quant_config(cfg, quant_mode: str, shape_name: str):
    """``cfg`` at ``--quant wXaY`` (int mode, an int8 KV cache for the
    decode shapes), as the reference's dry run sets it."""
    if quant_mode == "off":
        return cfg
    from repro_torch.nn.layers import QuantConfig
    return dataclasses.replace(
        cfg, quant=QuantConfig(mode="int", w_bits=int(quant_mode[1]),
                               a_bits=int(quant_mode[3])
                               if len(quant_mode) > 2 else 8),
        kv_quant_bits=8 if shape_name.startswith(("decode", "long"))
        else 16)


def _fresh(tree):
    """Every `Split` part of a placed meta tree as a storage of its own
    (on ``meta`` a placed part may be a view of the whole leaf)."""
    if isinstance(tree, dict):
        return {k: _fresh(v) for k, v in tree.items()}
    if isinstance(tree, tp.Split):
        return tp.Split([None if t is None else torch.empty_like(t)
                         for t in tree.parts], tree.cut)
    return tree


def holdings(tree, group=None, pos: int = 0):
    """[(tensor, position)] of a step input: a `Split` part at its group
    position, a `Sharded` shard at its position, any other tensor at the
    group's first position (or ``pos``)."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.values() if isinstance(tree, dict) else tree
        return [h for v in items for h in holdings(v, group, pos)]
    if isinstance(tree, tp.Split):
        return [(t, group.positions[i]) for i, t in enumerate(tree.parts)
                if t is not None]
    if isinstance(tree, Sharded):
        return list(zip(tree.shards, range(len(tree.shards))))
    if isinstance(tree, torch.Tensor):
        return [(tree, group.positions[0] if group is not None else pos)]
    return []


def position_bytes(held, n: int):
    """Bytes held at each of ``n`` positions (a tensor once per
    position)."""
    out, seen = [0] * n, set()
    for t, p in held:
        if (id(t), p) not in seen:
            seen.add((id(t), p))
            out[p] += t.numel() * t.element_size()
    return out


def _trace_mesh(mesh, all_blocks: bool):
    """The mesh the step is traced on: the whole mesh, or one data block
    (every non-model axis cut to 1)."""
    if all_blocks:
        return mesh
    shape = tuple(n if a == "model" else 1 for a, n in mesh.shape.items())
    return make_mesh(shape, mesh.axis_names, "meta")


def _build(model, cfg, shape: ShapeConfig, mesh, rules):
    """(step thunk, {input kind: [(tensor, position)]}); ``mesh`` None is
    one position."""
    from repro_torch.parallel.sharding import DEFAULT_RULES
    from repro_torch.train import step as st
    rules = rules or DEFAULT_RULES
    ins = st.input_shapes(model, shape)
    n_blocks = 1 if mesh is None else len(data_blocks(mesh))
    m = 1 if mesh is None else mesh.shape.get("model", 1)

    def rows(x):
        """``x``'s rows over the data blocks (whole at position 0 when
        meshless)."""
        if mesh is None:
            return x
        return device_put(x, NamedSharding(mesh, P(block_entry(mesh))))

    def placed(tree, cache=False):
        """(the step's tree, its holdings): placed on every block's group
        when ``model`` > 1, else whole at position 0."""
        if m == 1:
            return tree, holdings(tree, pos=0)
        trees = [_fresh(t) for t in st.place_blocks(model, mesh, tree,
                                                    cache=cache)]
        return trees, [h for b, t in enumerate(trees)
                       for h in holdings(t, tp.TPGroup(mesh, b))]

    if shape.kind == "train":
        from repro_torch.train.optimizer import OptConfig
        tcfg = st.TrainStepConfig()
        if cfg.param_dtype == "bfloat16":   # 100B+ archs: int8 m / v
            tcfg = st.TrainStepConfig(opt=OptConfig(state_bits=8))
        init_fn, step, _ = st.make_train_fns(model, mesh, shape, tcfg,
                                             rules, device="meta")
        state = init_fn(0)
        batch = {k: rows(v) for k, v in ins.items()}
        held = {"state": holdings(state, pos=0), "batch": holdings(batch)}
        return (lambda: step(state, batch)), held
    params, p_held = placed(st._meta_tree(model.defs()))
    if shape.kind == "prefill":
        step, _ = st.make_prefill_fns(model, mesh, shape, rules)
        held = {"params": p_held,
                "batch": holdings({k: rows(v) for k, v in ins.items()})}
        return (lambda: step(params, ins)), held
    step, _ = st.make_decode_fns(model, mesh, shape, rules)
    cache, c_held = placed(model.init_cache(
        shape.global_batch // n_blocks, shape.seq_len, device="meta")
        if m > 1 else ins["cache"], cache=True)
    held = {"params": p_held, "cache": c_held,
            "batch": holdings(rows(ins["token"]))}
    return (lambda: step(params, cache, ins["token"], ins["index"])), held


def trace_cell(model, cfg, shape: ShapeConfig, mesh, *, rules=None,
               all_blocks: bool = False, breakdown: bool = False) -> dict:
    """Trace one step of ``shape`` on ``mesh`` (one data block unless
    ``all_blocks``; None: meshless, one position): the `costs.Recorder`,
    the traced mesh, the traced rows, the argument bytes per position by
    kind, the output bytes per position."""
    n_blocks = 1 if mesh is None else len(data_blocks(mesh))
    tmesh = None if mesh is None else _trace_mesh(mesh, all_blocks)
    rows = shape.global_batch
    if not all_blocks and rows % n_blocks == 0:
        rows //= n_blocks
    tshape = dataclasses.replace(shape, global_batch=rows)
    run, held = _build(model, cfg, tshape, tmesh, rules)
    n = 1 if tmesh is None else tmesh.size
    rec = costs.Recorder(n, breakdown=breakdown)
    for h in held.values():
        for t, p in h:
            rec.own(t, p)
    with rec:
        out = run()
    out_bytes = [0] * n
    for t in costs._tensors(out):
        entry = rec._alloc.get(t.untyped_storage()._cdata)
        if entry is not None:
            out_bytes[entry[1]] += t.numel() * t.element_size()
    return {"recorder": rec, "mesh": tmesh, "rows": rows,
            "argument": {k: position_bytes(h, n) for k, h in held.items()},
            "output": out_bytes}


def dry_run_archs():
    """The registered archs the dry run models: latent attention and the
    dropless MoE dispatch (kimi-k2-instruct) have no mesh layout."""
    return [a for a in list_archs() if _modelled(get_config(a))]


def _modelled(cfg) -> bool:
    return not cfg.mla and (cfg.moe is None or not cfg.moe.experts_held)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             quant_mode: str = "off", save: bool = True, rules=None,
             tag: str = "", out_dir=None, breakdown: bool = False) -> dict:
    """One cell's record (module docstring), written to ``out_dir``
    (default ``build/dryrun/``) when ``save``."""
    if not _modelled(get_config(arch)):
        raise NotImplementedError(
            f"{arch}: the dry run has no mesh layout of latent attention "
            "or of the dropless MoE dispatch")
    cfg = quant_config(get_config(arch), quant_mode, shape_name)
    model = build(cfg)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    n_dev = mesh.size
    n_blocks = len(data_blocks(mesh))

    t0 = time.time()
    tr = trace_cell(model, cfg, shape, mesh, rules=rules,
                    breakdown=breakdown)
    trace_s = time.time() - t0
    rec, tmesh = tr["recorder"], tr["mesh"]
    n = tmesh.size
    argument = [sum(v[p] for v in tr["argument"].values())
                for p in range(n)]
    if shape.kind == "train" and n_blocks > 1:
        # the data-parallel gradient sum over the blocks (module docstring)
        grads = sum(math.prod(d.shape) * d.dtype.itemsize
                    for _, d in leaf_paths(model.defs()))
        for p in data_blocks(tmesh):
            pc = rec.positions[p]
            pc.sent["all-reduce"] += grads
            pc.received["all-reduce"] += grads
            pc.counts["all-reduce"] += len(leaf_paths(model.defs()))

    per = []
    for p, pc in enumerate(rec.positions):
        coll = rec.collective_bytes(p)
        out = tr["output"][p]
        per.append({
            "position": p,
            "bytes": {"argument": argument[p], "output": out,
                      "temp": pc.peak - out,
                      "total": argument[p] + pc.peak},
            "argument_by_kind": {k: v[p] for k, v in tr["argument"].items()},
            "flops": pc.flops, "int_ops": pc.int_ops,
            "io_bytes": pc.io_bytes,
            "collectives": {"counts": dict(pc.counts),
                            "in_bytes": dict(pc.sent),
                            "out_bytes": dict(pc.received),
                            "total_in": sum(pc.sent.values()),
                            "total_out": sum(pc.received.values())},
            "roofline": costs.roofline(pc.flops, pc.io_bytes, coll,
                                       int_ops_per_device=pc.int_ops)})
    mem = max(per, key=lambda r: r["bytes"]["total"])
    hot = max(per, key=lambda r: r["roofline"]["bound_s"])

    if shape.kind == "decode":
        tokens = shape.global_batch         # one token per sequence
    else:
        tokens = shape.global_batch * shape.seq_len
    n_act = active_params(model)
    mflops = (6.0 if shape.kind == "train" else 2.0) * n_act * tokens
    done = sum(r["flops"] + r["int_ops"] for r in per) * n_blocks

    rec_out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "devices": n_dev, "quant": quant_mode, "tag": tag,
        "trace_s": round(trace_s, 1),
        "traced_blocks": 1, "data_blocks": n_blocks,
        "rows_per_block": tr["rows"],
        "bytes_per_device": dict(mem["bytes"]),
        "argument_by_kind": mem["argument_by_kind"],
        "flops_per_device": hot["flops"],
        "int_ops_per_device": hot["int_ops"],
        "io_bytes_per_device": hot["io_bytes"],
        "collectives": hot["collectives"],
        "roofline": hot["roofline"],
        "model_flops_total": mflops,
        "useful_flops_ratio": mflops / max(done, 1.0),
        "n_active_params": n_act,
        "per_position": per,
    }
    if breakdown:
        rec_out["by_op"] = rec.by_op
    if save:
        out = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
        out.mkdir(parents=True, exist_ok=True)
        suffix = f"_{quant_mode}" if quant_mode != "off" else ""
        suffix += f"_{tag}" if tag else ""
        (out / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
         ).write_text(json.dumps(rec_out, indent=1))
    return rec_out


def pass_line(rec: dict) -> str:
    r = rec["roofline"]
    return (f"PASS {rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"mem/dev={rec['bytes_per_device']['total'] / 2**30:.2f}GiB "
            f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
            f"coll={r['collective_s']:.3e}s dom={r['dominant']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--quant", default="off",
                    help="off | w8a8 | w4a8 | w4a4 | w2a8 | w2a2")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {OUT_DIR})")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s.name) for a in dry_run_archs() for s in cells_for(a)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = []
    t0 = time.time()
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, args.mesh, args.quant, tag=args.tag,
                           out_dir=args.out)
            print(pass_line(rec), f"trace={rec['trace_s']}s", flush=True)
        except Exception as e:   # a cell's fault is reported, the rest run
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} {shape}: {e}", flush=True)
            traceback.print_exc()
    print(f"{len(cells) - len(failures)} of {len(cells)} cells passed on "
          f"{args.mesh} in {time.time() - t0:.1f} s (CPU, meta tensors)",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
