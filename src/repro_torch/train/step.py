"""Train / serve step builders over a (data, model) mesh.

``train_step`` = loss -> backward (`torch.autograd`) -> optional int8
gradient compression with error feedback (`train.compress`; the
feedback state kept in bfloat16, as the reference keeps it) -> AdamW.

One controller holds the state on one device, replicated in the
reference's sense. A mesh's ``data`` axis splits each batch: every data
block runs the forward and backward of its rows (one stream each where
positions share a card, `parallel.mesh.run_per_shard`), differentiating
its share of the global loss (its rows' mean scaled by their fraction of
the batch), and the gradients are summed. The per-token terms (the NLL
and the z-loss) sum to the global mean; an MoE aux loss is each shard's,
weighted the same way. A ``model`` axis above 1 splits each block's
forward over its model positions (`repro_torch.parallel.tp`: heads, MLP
columns, experts, recurrence channels and vocab rows, each block ending
in one reduction): the blocks slice the whole leaves inside the
forward, so autograd sums every slice's gradient into its leaf and the
backward needs nothing written by hand.

The decode and prefill builders return the reference's placements of
their inputs (from its logical rules) and run the same split: rows over
``data``, each block tensor-parallel over ``model``; the train state
stays whole on its device.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.api import Model
from repro_torch.nn.module import ParamDef, leaf_paths, tree_like
from repro_torch.parallel import tp
from repro_torch.parallel.mesh import (NamedSharding, P, Sharded,
                                       block_entry, block_of, data_blocks)
from repro_torch.parallel.sharding import (DEFAULT_RULES, batch_sharding,
                                           cache_shardings, params_shardings)
from repro_torch.train.compress import compress_grads
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: OptConfig = OptConfig()
    grad_compress_bits: int = 32   # 32 (off) | 8 (int8 + error feedback)


def _scope(mesh, q: int):
    """The tensor-parallel scope of the data block at position ``q``."""
    if tp.model_size(mesh) == 1:
        return contextlib.nullcontext()
    return tp.tp_scope(tp.TPGroup(mesh, block_of(mesh, q)))


def _per_block(mesh, fn, rows: int):
    """``fn(i, scope, sl)`` for each data block ``i`` and its row slice
    ``sl`` of ``rows``, in block order: the outputs by block."""
    pos = data_blocks(mesh)
    b = rows // len(pos)
    if rows % len(pos):
        raise ValueError(f"{rows} rows do not divide over "
                         f"{len(pos)} data blocks")
    return [fn(i, _scope(mesh, q), slice(i * b, (i + 1) * b))
            for i, q in enumerate(pos)]


def _of_block(tree, i: int):
    """Block ``i``'s own tree where ``tree`` is a list of them (placed on
    each block's group, `place_blocks`), else ``tree``."""
    return tree[i] if isinstance(tree, list) else tree


def place_blocks(model: Model, mesh, tree, cache: bool = False) -> list:
    """``tree`` placed on each data block's model positions, as the
    serving adapter holds it (weight-stationary params, or with
    ``cache`` a block's cache rows, which the caller sizes per block):
    one tree per block, for the step builders' ``params`` / ``cache``."""
    groups = [tp.TPGroup(mesh, b) for b in range(len(data_blocks(mesh)))]
    place = model.place_cache if cache else model.place
    return [place(tree, g) for g in groups]


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
    # decode's index: the last position, a Python int (a 0-dim meta
    # tensor has no value for attention's `int(index)`)
    return {"token": meta(b, 1), "index": s - 1,
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
    from repro_torch.parallel.mesh import device_put, run_per_shard
    shard = NamedSharding(mesh, P(block_entry(mesh)))
    split = {k: (v if isinstance(v, Sharded) else device_put(v, shard))
             for k, v in batch.items()}
    n = next(iter(split.values())).shape[0]
    pos = data_blocks(mesh)
    parts = [{k: v.shards[p] for k, v in split.items()} for p in pos]
    flat = mesh.flat
    def block(q, part):
        with _scope(mesh, q):
            return one(part["tokens"].shape[0] / n, part, flat[q])

    outs = run_per_shard(mesh, block, [(part,) for part in parts], pos)
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
    reference's placements of params, cache, token and index. On a mesh
    with ``model`` > 1, ``params`` and ``cache`` may instead be lists of
    one tree per data block placed on its group (`place_blocks`; each
    cache holds its block's rows), as the serving adapter holds them."""
    specs = model.specs()
    shapes = _meta_tree(model.defs())
    in_shapes = input_shapes(model, shape)

    def decode_step(params, cache, token, index):
        if tp.model_size(mesh) == 1:
            return model.decode(params, cache, token, index)

        def block(i, scope, sl):
            rows = (cache[i] if isinstance(cache, list)
                    else _tree_rows(cache, sl))
            idx = index[sl] if torch.is_tensor(index) and index.dim() \
                else index
            with scope:
                return model.decode(_of_block(params, i), rows, token[sl],
                                    idx)[0]
        return torch.cat(_per_block(mesh, block, token.shape[0])), cache

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
    position's logits (B, 1, V); ``params`` as in `make_decode_fns`."""
    specs = model.specs()
    shapes = _meta_tree(model.defs())

    def prefill_step(params, batch):
        if tp.model_size(mesh) == 1:
            logits, _, _ = model.forward(params, batch)
            return logits[:, -1:]

        def block(i, scope, sl):
            with scope:
                return model.forward(_of_block(params, i),
                                     {k: v[sl] for k, v in
                                      batch.items()})[0][:, -1:]
        return torch.cat(_per_block(mesh, block,
                                    batch["tokens"].shape[0]))

    shard = None
    if mesh is not None:
        shard = {"params": params_shardings(specs, shapes, mesh, rules),
                 "batch": {k: batch_sharding(mesh, v.dim(), rules,
                                             tuple(v.shape))
                           for k, v in input_shapes(model, shape).items()}}
    return prefill_step, shard


def _tree_rows(cache, sl):
    """Rows ``sl`` (dim 1) of every cache leaf, as views: a block's
    in-place writes land in the whole cache."""
    if isinstance(cache, dict):
        return {k: _tree_rows(v, sl) for k, v in cache.items()}
    return cache[:, sl]
