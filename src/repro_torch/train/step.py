"""Train / serve step builders over a (data, model) mesh.

``train_step`` = loss -> backward (`torch.autograd`) -> optional int8
gradient compression with error feedback (`train.compress`; the
feedback state kept in bfloat16, as the reference keeps it) -> AdamW.

One controller holds the state on one device, replicated in the
reference's sense. A mesh's ``data`` axis splits each batch: every data
position runs the forward and backward of its rows on its device (one
stream each where positions share a card, `parallel.mesh.run_per_shard`),
differentiating its share of the global loss (its rows' mean scaled by
their fraction of the batch), and the gradients are summed. The
per-token terms (the NLL and the z-loss) sum to the global mean; an MoE
aux loss is each shard's, weighted the same way. A ``model`` axis above
1 (tensor parallelism over heads and MLP columns) is not ported.

The decode and prefill builders return the reference's placements of
their inputs (from its logical rules); the train state stays whole on
its device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.api import Model
from repro_torch.nn.module import ParamDef, leaf_paths, tree_like
from repro_torch.parallel.mesh import NamedSharding, P, Sharded
from repro_torch.parallel.sharding import (DEFAULT_RULES, batch_sharding,
                                           cache_shardings, params_shardings)
from repro_torch.train.compress import compress_grads
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: OptConfig = OptConfig()
    grad_compress_bits: int = 32   # 32 (off) | 8 (int8 + error feedback)


def _check_mesh(mesh, what: str) -> None:
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"{what} on a 'model' axis of {mesh.shape['model']}: explicit "
            "LM tensor parallelism over 'model' is not ported yet (ROADMAP "
            "Queue 1, 'Explicit LM tensor parallelism over model'); use "
            "a (data, 1) mesh")


def _meta_tree(defs):
    """ParamDef tree -> tree of meta tensors of the same shapes."""
    if isinstance(defs, ParamDef):
        return torch.empty(defs.shape, dtype=defs.dtype, device="meta")
    return {k: _meta_tree(v) for k, v in defs.items()}


def input_shapes(model: Model, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every input of a step at ``shape`` (the
    reference's ``Model.input_specs``)."""
    cfg = model.cfg
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    needs_src = cfg.family == "encdec" or cfg.cross_every > 0

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        spec = {"tokens": meta(b, s), "labels": meta(b, s)}
        if needs_src:
            spec["src_embed"] = meta(b, s, d, dtype=torch.bfloat16)
        return spec
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"tokens": meta(b, 256),
                    "src_embed": meta(b, s, d, dtype=torch.bfloat16)}
        spec = {"tokens": meta(b, s)}
        if needs_src:
            spec["src_embed"] = meta(b, cfg.src_len, d, dtype=torch.bfloat16)
        return spec
    return {"token": meta(b, 1), "index": meta(),
            "cache": model.init_cache(b, s, device="meta")}


def loss_and_grads(model: Model, params, batch, mesh=None):
    """(loss, gradients as a list in `optimizer.leaf_paths` order) of
    ``model.loss`` at ``params``, the batch split over ``mesh``'s data
    axis when one is given."""
    paths, leaves = zip(*leaf_paths(params))

    def one(share, part, dev):
        """This part's loss (times its share of the batch) and gradients,
        on ``dev``."""
        req = [t.detach().to(dev).requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            loss = model.loss(tree_like(zip(paths, req)), part) * share
            grads = torch.autograd.grad(loss, req)
        return loss.detach(), grads

    if mesh is None:
        loss, grads = one(1.0, batch, leaves[0].device)
        return loss, list(grads)
    from repro_torch.parallel.mesh import (axis_positions, device_put,
                                           run_per_shard)
    shard = NamedSharding(mesh, P("data"))
    split = {k: (v if isinstance(v, Sharded) else device_put(v, shard))
             for k, v in batch.items()}
    n = next(iter(split.values())).shape[0]
    pos = axis_positions(mesh, "data")
    parts = [{k: v.shards[p] for k, v in split.items()} for p in pos]
    flat = mesh.flat
    outs = run_per_shard(
        mesh, lambda q, part: one(
            part["tokens"].shape[0] / n, part, flat[q]),
        [(part,) for part in parts], pos)
    dev = leaves[0].device
    loss = sum(o[0].to(dev) for o in outs)
    grads = [sum(o[1][i].to(dev) for o in outs) for i in range(len(leaves))]
    return loss, grads


def make_train_fns(model: Model, mesh, shape: ShapeConfig,
                   tcfg: TrainStepConfig = TrainStepConfig(),
                   rules=DEFAULT_RULES, device="cuda"):
    """(init_fn, train_step, shardings).

    init_fn(seed) -> state {params, opt[, ef]} on ``device``;
    train_step(state, batch) -> (state, metrics {loss, grad_norm, lr}),
    ``batch`` a dict of tensors (or `Sharded` over ``mesh``'s data axis).
    ``shardings["batch"]`` places the inputs on ``mesh``;
    ``shardings["state"]`` is None: the state stays whole on ``device``.
    """
    _check_mesh(mesh, "training")
    use_ef = tcfg.grad_compress_bits == 8

    def init_fn(seed: int = 0):
        params = model.init(seed, device=device)
        state = {"params": params, "opt": adamw_init(params, tcfg.opt)}
        if use_ef:
            state["ef"] = tree_like(
                (p, torch.zeros(t.shape, dtype=torch.bfloat16,
                                device=t.device))
                for p, t in leaf_paths(params))
        return state

    def train_step(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(model, params, batch, mesh)
        grads = tree_like(zip((p for p, _ in leaf_paths(params)), grads))
        if use_ef:
            grads, new_ef = compress_grads(grads, state["ef"])
        new_params, new_opt, metrics = adamw_update(
            params, grads, state["opt"], tcfg.opt)
        metrics["loss"] = loss
        new_state = {"params": new_params, "opt": new_opt}
        if use_ef:
            new_state["ef"] = new_ef
        return new_state, metrics

    shardings = {"state": None, "batch": None}
    if mesh is not None:
        shardings["batch"] = {
            k: batch_sharding(mesh, v.dim(), rules, tuple(v.shape))
            for k, v in input_shapes(model, shape).items()}
    return init_fn, train_step, shardings


def make_decode_fns(model: Model, mesh, shape: ShapeConfig,
                    rules=DEFAULT_RULES):
    """(decode_step, shardings) for serving: decode_step(params, cache,
    token, index) -> (logits, cache) over global tensors, and the
    reference's placements of params, cache, token and index."""
    _check_mesh(mesh, "decode")
    specs = model.specs()
    shapes = _meta_tree(model.defs())
    in_shapes = input_shapes(model, shape)

    def decode_step(params, cache, token, index):
        return model.decode(params, cache, token, index)

    shard = None
    if mesh is not None:
        shard = {"params": params_shardings(specs, shapes, mesh, rules),
                 "cache": cache_shardings(in_shapes["cache"], mesh, rules),
                 "token": batch_sharding(mesh, 2, rules,
                                         tuple(in_shapes["token"].shape)),
                 "index": NamedSharding(mesh, P())}
    return decode_step, shard


def make_prefill_fns(model: Model, mesh, shape: ShapeConfig,
                     rules=DEFAULT_RULES):
    """(prefill_step, shardings): prefill_step(params, batch) -> the last
    position's logits (B, 1, V)."""
    _check_mesh(mesh, "prefill")
    specs = model.specs()
    shapes = _meta_tree(model.defs())

    def prefill_step(params, batch):
        logits, _, _ = model.forward(params, batch)
        return logits[:, -1:]

    shard = None
    if mesh is not None:
        shard = {"params": params_shardings(specs, shapes, mesh, rules),
                 "batch": {k: batch_sharding(mesh, v.dim(), rules,
                                             tuple(v.shape))
                           for k, v in input_shapes(model, shape).items()}}
    return prefill_step, shard
