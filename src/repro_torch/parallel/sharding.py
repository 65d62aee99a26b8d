"""Logical-axis sharding rules -> PartitionSpecs, and the packed-artifact
rules of the cluster path.

**Paper analogy (XpulpNN fig. 9).** A mesh position plays one core of the
paper's 8-core PULP cluster: the ``model`` axis is the cluster (operands
resident per core, collective-free integer inner loops), ``data`` /
``pod`` is multi-cluster scale-out.

Default assignment of logical axes to mesh axes:

  batch        -> (pod, data)    data parallel
  vocab/heads/kv_heads/mlp/expert_mlp/experts -> model   (TP / EP)
  embed        -> data           ZeRO-3 / FSDP weight sharding
  kv_seq       -> model          sequence-parallel KV cache
  layers/stack -> None

**Packed sub-byte arrays** (`repro_torch.core.packing`) shard **only on
the output-feature axis N**: a packed weight (K_pad // pack_factor, N)
holds ``pack_factor`` logical elements per int8 container along K, so an
N split keeps every CHUNK group on one shard, the int32 accumulation runs
over the whole K on each shard, and the per-N epilogue (kappa, lam, m,
a per-channel dequant scale) is local: no psum anywhere, every shard's
result exact against one device. `packed_linear_specs` never splits the
packed K axis.

**LM tensor parallelism** (`repro_torch.parallel.tp`, the blocks'
``*_cuts``) places an LM params tree by the same logical axes: a dense
whose N axis maps to ``model`` splits its columns, one whose K axis does
splits its packed K only at CHUNK boundaries (the int32 partials of the
slices add exactly, one dequant follows), a segmented container stays
whole. A decode cache follows `cache_shardings`: kv heads over ``model``
where they divide it, else the sequence (``kv_seq``), the cross cache
one dim in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.parallel.mesh import (Mesh, NamedSharding, P, device_put,
                                       tree_map)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: tuple = (
        ("batch", ("pod", "data")),
        ("batch_full", ("pod", "data", "model")),
        ("vocab", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("mlp", "model"),
        ("mlp2", None),
        ("expert_mlp", "model"),
        ("experts", "model"),
        ("embed", "data"),       # ZeRO-3 shard dim
        ("opt_shard", ("data", "model")),  # blocked int8 optimizer states
        ("kv_seq", "model"),     # sequence-parallel KV
        ("seq_model", "model"),  # context-parallel fallback for few-head GQA
        ("seq", None),
        ("layers", None),
    )

    def lookup(self, name):
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def spec(self, axes, mesh: Mesh) -> P:
        """Logical axes -> PartitionSpec, dropping mesh axes the mesh
        lacks or an earlier dim already used."""
        out = []
        used = set()
        for ax in axes:
            tgt = self.lookup(ax) if ax is not None else None
            tgt_t = tgt if isinstance(tgt, tuple) else (
                (tgt,) if tgt else ())
            tgt_t = tuple(t for t in tgt_t
                          if t in mesh.axis_names and t not in used)
            used.update(tgt_t)
            if len(tgt_t) == 0:
                out.append(None)
            elif len(tgt_t) == 1:
                out.append(tgt_t[0])
            else:
                out.append(tgt_t)
        return P(*out)


DEFAULT_RULES = ShardingRules()

# the cluster path's two axes: activation rows, images and serving slots
# are data-parallel over DP_AXIS, packed weights tensor-parallel over
# TP_AXIS
DP_AXIS, TP_AXIS = "data", "model"


def _divisible(dim: int, spec_entry, mesh: Mesh) -> bool:
    if spec_entry is None:
        return True
    axes = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return dim % n == 0


def shard_spec_for(shape, axes, mesh: Mesh,
                   rules: ShardingRules = DEFAULT_RULES) -> P:
    """PartitionSpec with a divisibility fallback: a mesh axis that does
    not divide the dim is dropped (the dim replicated)."""
    spec = rules.spec(axes, mesh)
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        fixed.append(entry if _divisible(dim, entry, mesh) else None)
    return P(*fixed)


def params_shardings(spec_tree, shape_tree, mesh: Mesh,
                     rules: ShardingRules = DEFAULT_RULES):
    """Logical-spec tree (leaves: axis tuples) + shapes tree (leaves with
    ``.shape``) -> NamedSharding tree."""
    return tree_map(
        lambda axes, shaped: NamedSharding(
            mesh, shard_spec_for(tuple(shaped.shape), axes, mesh, rules)),
        spec_tree, shape_tree)


def batch_sharding(mesh: Mesh, ndim: int,
                   rules: ShardingRules = DEFAULT_RULES,
                   shape=None) -> NamedSharding:
    """Inputs: dim 0 (batch) over (pod, data), dropping axes the batch
    dim cannot divide."""
    if shape is not None:
        spec = shard_spec_for(tuple(shape), ("batch",) + (None,) *
                              (ndim - 1), mesh, rules)
        return NamedSharding(mesh, spec)
    entry = rules.spec(("batch",), mesh)
    return NamedSharding(mesh, P(entry[0], *([None] * (ndim - 1))))


def cache_shardings(cache_shapes, mesh: Mesh,
                    rules: ShardingRules = DEFAULT_RULES):
    """Decode caches (a tree of leaves with ``.shape``): KV (layers,
    batch, seq, kv_heads, head_dim) shards batch over (pod, data) and
    kv_heads over model, falling back to the sequence when the heads do
    not divide; a cross cache (layers, 2, batch, ...) the same one dim
    in; recurrent states (layers, batch, ...) batch over data."""
    def one(s):
        shape = tuple(s.shape)
        if len(shape) == 5:
            return NamedSharding(mesh, _kv_spec(shape, mesh, rules))
        if len(shape) == 6:
            p = _kv_spec(shape[1:], mesh, rules)
            return NamedSharding(mesh, P(None, *tuple(p)))
        entry = rules.spec(("batch",), mesh)[0]
        if len(shape) >= 2 and _divisible(shape[1], entry, mesh):
            return NamedSharding(
                mesh, P(None, entry, *([None] * (len(shape) - 2))))
        return NamedSharding(mesh, P(*([None] * len(shape))))
    return tree_map(one, cache_shapes)


def _kv_spec(shape, mesh, rules):
    """(L, B, T, Hk, Dh): batch -> (pod, data), heads -> model; if the
    heads do not divide model, shard T (sequence parallel) instead."""
    _, b, t, hk, _ = shape
    bent = rules.spec(("batch",), mesh)[0]
    bent = bent if _divisible(b, bent, mesh) else None
    ment = "model" if hk % mesh.shape.get("model", 1) == 0 else None
    tent = None
    if ment is None and t % mesh.shape.get("model", 1) == 0:
        tent = "model"
    return P(None, bent, tent, ment, None)


# ------------------------------------------------- packed QNN artifacts ---

def cluster_axis_size(mesh: Mesh, axis: Optional[str]) -> int:
    """Size of a mesh axis; an absent or None axis counts as 1."""
    if axis is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


def axis_entry(mesh: Mesh, axis: Optional[str]):
    """PartitionSpec entry for an axis: None when the mesh lacks it."""
    return axis if axis is not None and axis in mesh.axis_names else None


def packed_linear_specs(params, mesh: Mesh):
    """PartitionSpecs of a `QuantizedLinearParams`, TP over N only:
    ``w_packed`` -> P(None, tp), ``kappa``/``lam``/``m`` -> P(tp). Raises
    when N does not divide the tp axis: a packed weight is a static
    artifact, and replicating it quietly would hide a mis-sized mesh."""
    tp = cluster_axis_size(mesh, TP_AXIS)
    n = params.w_packed.shape[1]
    if n % tp != 0:
        raise ValueError(
            f"packed linear: output features N={n} not divisible by "
            f"mesh axis {TP_AXIS!r} size {tp}; pad Cout at quantization "
            "time or use a smaller cluster")
    ent = axis_entry(mesh, TP_AXIS) if tp > 1 else None
    return {"w_packed": P(None, ent), "kappa": P(ent), "lam": P(ent),
            "m": P(ent)}


def shard_packed_linear(params, mesh: Mesh):
    """A `QuantizedLinearParams` with its arrays placed per
    `packed_linear_specs`: the weights resident per shard before serving
    (the cluster's weight-stationary setup step)."""
    specs = packed_linear_specs(params, mesh)
    return dataclasses.replace(params, **{
        k: device_put(getattr(params, k), NamedSharding(mesh, s))
        for k, s in specs.items()})


def packed_conv_specs(params, mesh: Mesh):
    """PartitionSpecs of a `QuantizedConvParams`: the fused per-tap
    layout (K_tap_pad // pf, Cout) shards on Cout like the GEMM layout."""
    gemm = packed_linear_specs(params.gemm, mesh)
    return {"gemm": gemm, "w_packed_fused": gemm["w_packed"]}


def shard_packed_conv(params, mesh: Mesh):
    """A `QuantizedConvParams` placed per `packed_conv_specs`."""
    specs = packed_conv_specs(params, mesh)
    return dataclasses.replace(
        params, gemm=shard_packed_linear(params.gemm, mesh),
        w_packed_fused=device_put(params.w_packed_fused,
                                  NamedSharding(mesh,
                                                specs["w_packed_fused"])))
