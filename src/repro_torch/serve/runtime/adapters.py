"""Workload adapters for the serving runtime.

`WorkloadAdapter` is the contract between the scheduler (admission,
slots, stats) and a workload (what a request is and what one engine step
computes): ``init_state``/``reset_state`` for carried per-slot state,
``step(state, feed, positions)`` for one step over all slots, and the
request cursor hooks ``begin``/``feed``/``consume`` (whose return value
is the finished predicate). Every step must be row-independent, which
makes per-request outputs independent of batching and admission order.

On a mesh (``mesh=``) the slots split into ``dp`` contiguous data blocks,
one per position of the ``data`` axis (the scheduler pads the slot count
to a multiple of ``dp``). Each block's step runs on its position's
device, on a stream of its own where several share a card
(`repro_torch.parallel.mesh.run_per_shard`), and the rows are gathered
back in slot order, so per-request outputs equal the meshless ones. A
``model`` axis above 1 splits each block's step over the block's model
positions (`repro_torch.parallel.tp`): LM tensor parallelism.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel import tp
from repro_torch.parallel.mesh import (NamedSharding, assemble,
                                       data_blocks, run_per_shard,
                                       tree_map)
from repro_torch.parallel.sharding import (DP_AXIS, TP_AXIS,
                                           cache_shardings,
                                           cluster_axis_size)

# per-slot carried state that must be cleared on slot reuse, keyed by the
# cache subtree name: leaves are (layers, slots, ...) with zero init
STATE_RESET_KEYS = ("ssm", "rec")


class WorkloadAdapter:
    """Base contract; subclasses set ``name`` and ``max_len`` and
    implement the hooks below. ``mesh``: the mesh the adapter serves on
    (None: one device); the scheduler splits its slots over its ``data``
    axis."""

    name: str = "?"
    max_len: int = 1
    mesh = None

    def init_state(self, slots: int):
        return None

    def reset_state(self, state, slot_mask: np.ndarray):
        """Clear carried per-slot state where the mask is True."""
        return state

    def input_spec(self) -> Tuple[Tuple[int, ...], Any]:
        """(per-slot feed shape, dtype) of the scheduler's feed buffer."""
        raise NotImplementedError

    def step(self, state, feed: np.ndarray, positions: np.ndarray):
        """One step over all slots -> (per-slot host outputs, state)."""
        raise NotImplementedError

    def begin(self, payload, *, rid: int, greedy: bool = True,
              seed: int = 0):
        raise NotImplementedError

    def feed(self, cursor) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def consume(self, cursor, row) -> bool:
        raise NotImplementedError

    def finish(self, cursor):
        """Attach final outputs to the payload (called exactly once)."""

    def result(self, cursor):
        return cursor.payload

    def reserve_tokens(self, cursor) -> int:
        return self.max_len

    def prompt_len(self, cursor) -> int:
        return 1

    def tokens_out(self, cursor) -> int:
        return 0


# ------------------------------------------------------------- LM decode ---

@dataclasses.dataclass
class Request:
    """One LM generation request."""
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32
    out: Optional[np.ndarray] = None


@dataclasses.dataclass
class _LMCursor:
    payload: Request
    rid: int
    prompt: np.ndarray
    max_new: int
    greedy: bool
    rng: Optional[np.random.Generator]
    next_pos: int = 0               # next cache position to feed
    pending: int = 0                # last sampled token, fed next
    out: Optional[List[int]] = None
    done: bool = False


def _tree_device(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


class LMDecodeAdapter(WorkloadAdapter):
    """Token-synchronous LM decode over the Model API, on the device the
    params live on.

    Prefill and decode are the same ``model.decode`` call with a per-slot
    position vector: a slot working through its prompt is fed prompt
    tokens (outputs ignored until the last prompt position), then its
    generated tokens. Output k exists iff ``k < max_new_tokens`` and
    ``prompt_len + k < max_len`` and no earlier EOS; the EOS token itself
    is emitted. Non-greedy sampling draws from a per-request generator
    seeded ``(seed, rid)``, so outputs do not depend on admission order.

    With ``mesh=`` each data block of slots decodes on its own device
    (module docstring), the params replicated once per distinct device
    (blocks that share a card share one copy), and the cache is a tree
    of `Sharded` leaves placed per `cache_shardings`' batch entry. With
    a ``model`` axis above 1 each data block is a `TPGroup`: the params
    are placed once per distinct set of devices (`Model.place`: heads,
    MLP columns, experts, recurrence channels and vocab rows over the
    block's model positions), each block's cache is placed on both axes
    (its rows, then `Model.place_cache`: kv heads or the sequence,
    recurrent channels) and held in a `TPState`, and each step runs the
    block's decode tensor-parallel.
    """

    name = "lm"

    def __init__(self, model, params, max_len: int, *, eos_id: int = 1,
                 plan=None, mesh=None):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.eos = eos_id
        self.plan = plan
        self.device = _tree_device(params)
        self.mesh = mesh
        if mesh is None:
            return
        from repro_torch.convert import to_device

        if mesh.device_type != self.device.type:
            raise ValueError(f"the params live on {self.device}, the mesh "
                             f"on {mesh.device_type} devices")
        # data block d runs at its first position (`data_blocks`)
        self._block_pos = data_blocks(mesh)
        self.dp = len(self._block_pos)
        self.tp = cluster_axis_size(mesh, TP_AXIS)
        self._params = {}
        if self.tp > 1:
            self._groups = [tp.TPGroup(mesh, d) for d in range(self.dp)]
            for g in self._groups:
                key = tuple(str(d) for d in g.devices)
                if key not in self._params:
                    self._params[key] = model.place(params, g)
            return
        for p in self._block_pos:
            dev = mesh.flat[p]
            if dev not in self._params:
                self._params[dev] = (params if dev == self.device
                                     else to_device(params, dev))

    def block_params(self, d: int):
        """The params data block ``d`` decodes with (placed over its
        model positions when ``model`` > 1)."""
        if self.tp > 1:
            g = self._groups[d]
            return self._params[tuple(str(x) for x in g.devices)]
        return self._params[self.mesh.flat[self._block_pos[d]]]

    def init_state(self, slots: int):
        if self.mesh is None:
            return self.model.init_cache(slots, self.max_len,
                                         device=self.device)
        if self.tp > 1:
            return TPState([self.model.place_cache(
                self.model.init_cache(slots // self.dp, self.max_len,
                                      device=g.leader), g)
                for g in self._groups])
        specs = cache_shardings(
            self.model.init_cache(slots, self.max_len, device="meta"),
            self.mesh)
        flat = self.mesh.flat
        local = {p: self.model.init_cache(slots // self.dp, self.max_len,
                                          device=flat[p])
                 for p in self._block_pos}
        return self._assemble(specs, local, slots)

    def _assemble(self, specs, local, slots):
        """Per-block cache trees (``local[pos]``) -> one tree of `Sharded`
        leaves of ``slots`` rows."""
        def leaf(sharding: NamedSharding, *blocks):
            shape = list(blocks[0].shape)
            shape[_batch_dim(sharding)] = slots
            return assemble(self.mesh, sharding.spec, shape,
                            dict(zip(self._block_pos, blocks)))

        return tree_map(leaf, specs, *(local[p] for p in self._block_pos))

    def reset_state(self, cache, slot_mask: np.ndarray):
        """Zero the carried recurrent rows (SSM / RG-LRU) of re-admitted
        slots, in place in the tensors the scheduler holds; positional
        KV is left alone (the mask admits only positions the new request
        has itself written)."""
        tree = cache.blocks[0] if isinstance(cache, TPState) else cache
        keys = [k for k in STATE_RESET_KEYS if k in tree]
        if not keys or not slot_mask.any():
            return cache
        slot_mask = np.asarray(slot_mask, bool)
        if isinstance(cache, TPState):
            b = len(slot_mask) // self.dp
            for d, tree in enumerate(cache.blocks):
                for k in keys:
                    _clear_rows(tree[k], slot_mask[d * b:(d + 1) * b])
            return cache
        if self.mesh is None:
            blocks = [(None, torch.from_numpy(slot_mask).to(self.device))]
        else:
            b = len(slot_mask) // self.dp
            blocks = [(p, torch.from_numpy(slot_mask[i * b:(i + 1) * b])
                       .to(self.mesh.flat[p]))
                      for i, p in enumerate(self._block_pos)]

        def clear(tree):
            for leaf in tree.values():
                if isinstance(leaf, dict):
                    clear(leaf)
                    continue
                for p, mask in blocks:
                    (leaf if p is None else leaf.shards[p])[:, mask] = 0

        for k in keys:
            clear(cache[k])
        return cache

    def input_spec(self):
        return ((1,), np.int32)

    def step(self, cache, feed, positions):
        if isinstance(cache, TPState):
            return self._step_tp(cache, feed, positions)
        if self.mesh is not None:
            return self._step_mesh(cache, feed, positions)
        tok = torch.from_numpy(feed).to(self.device)
        pos = torch.from_numpy(positions.astype(np.int64)).to(self.device)
        logits, cache = self.model.decode(self.params, cache, tok, pos)
        return logits[:, -1].to(torch.float32).cpu().numpy(), cache

    def _step_mesh(self, cache, feed, positions):
        b = len(feed) // self.dp
        flat = self.mesh.flat
        inputs = []
        for i, p in enumerate(self._block_pos):
            rows = slice(i * b, (i + 1) * b)
            inputs.append((
                torch.from_numpy(feed[rows]).to(flat[p]),
                torch.from_numpy(positions[rows].astype(np.int64))
                .to(flat[p]),
                tree_map(lambda s, p=p: s.shards[p], cache)))

        def local(p, tok, pos, block_cache):
            logits, block_cache = self.model.decode(
                self._params[flat[p]], block_cache, tok, pos)
            return logits[:, -1].to(torch.float32), block_cache

        outs = run_per_shard(self.mesh, local, inputs, self._block_pos)
        rows = np.concatenate([o[0].cpu().numpy() for o in outs])
        local_trees = dict(zip(self._block_pos, (o[1] for o in outs)))
        specs = tree_map(lambda s: s.sharding, cache)
        return rows, self._assemble(specs, local_trees, len(feed))

    def _step_tp(self, state, feed, positions):
        """Each data block's decode, tensor-parallel over its model
        positions, the blocks on their leaders' streams."""
        b = len(feed) // self.dp
        inputs = [(torch.from_numpy(feed[d * b:(d + 1) * b]).to(g.leader),
                   torch.from_numpy(positions[d * b:(d + 1) * b]
                                    .astype(np.int64)).to(g.leader), d)
                  for d, g in enumerate(self._groups)]

        def local(p, tok, pos, d):
            with tp.tp_scope(self._groups[d]):
                logits, _ = self.model.decode(self.block_params(d),
                                              state.blocks[d], tok, pos)
            return logits[:, -1].to(torch.float32)

        outs = run_per_shard(self.mesh, local, inputs,
                             [g.positions[0] for g in self._groups])
        return np.concatenate([o.cpu().numpy() for o in outs]), state

    def begin(self, payload: Request, *, rid: int, greedy: bool = True,
              seed: int = 0):
        prompt = np.asarray(payload.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            prompt = np.zeros((1,), np.int32)   # a single BOS(=0) token
        max_new = int(payload.max_new_tokens)
        cur = _LMCursor(
            payload=payload, rid=rid, prompt=prompt, max_new=max_new,
            greedy=greedy,
            rng=None if greedy else np.random.default_rng((seed, rid)),
            out=[])
        if max_new <= 0:
            cur.done = True        # completes without occupying a slot
        return cur

    def reserve_tokens(self, cur: _LMCursor) -> int:
        return len(cur.prompt) + cur.max_new

    def prompt_len(self, cur: _LMCursor) -> int:
        return len(cur.prompt)

    def feed(self, cur: _LMCursor):
        p = cur.next_pos
        tok = cur.prompt[p] if p < len(cur.prompt) else cur.pending
        return np.asarray([tok], np.int32), p

    def _sample(self, cur: _LMCursor, row: np.ndarray) -> int:
        if cur.greedy:
            return int(row.argmax(-1))
        p = np.exp(row - row.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        return int(cur.rng.choice(row.shape[-1], p=p))

    def consume(self, cur: _LMCursor, row: np.ndarray) -> bool:
        q = cur.next_pos            # the position just fed
        cur.next_pos = q + 1
        if q < len(cur.prompt) - 1:
            return False            # still prefilling: output ignored
        if len(cur.out) < cur.max_new and cur.next_pos < self.max_len:
            nxt = self._sample(cur, row)
            cur.out.append(nxt)
            cur.pending = nxt
            if (nxt == self.eos or len(cur.out) >= cur.max_new
                    or cur.next_pos + 1 >= self.max_len):
                cur.done = True
        else:
            cur.done = True         # no room left for another token
        return cur.done

    def finish(self, cur: _LMCursor):
        cur.payload.out = np.array(cur.out, np.int32)

    def tokens_out(self, cur: _LMCursor) -> int:
        return len(cur.out)


@dataclasses.dataclass
class TPState:
    """The decode cache of a tensor-parallel mesh: one placed cache tree
    per data block (`Split` leaves over its model positions, the block's
    rows on dim 1 of every leaf)."""
    blocks: list


def _clear_rows(tree, mask: np.ndarray):
    """Zero rows ``mask`` (dim 1) of every leaf and part of ``tree``."""
    for leaf in tree.values():
        if isinstance(leaf, dict):
            _clear_rows(leaf, mask)
            continue
        parts = leaf.parts if isinstance(leaf, tp.Split) else [leaf]
        for t in parts:
            if t is not None:
                t[:, torch.from_numpy(mask).to(t.device)] = 0


def _batch_dim(sharding: NamedSharding) -> int:
    """The dim a cache leaf's spec splits over the ``data`` axis."""
    for i, entry in enumerate(sharding.spec):
        if entry == DP_AXIS or (isinstance(entry, tuple)
                                and DP_AXIS in entry):
            return i
    raise ValueError(f"cache spec {sharding.spec} does not split the "
                     f"batch over {DP_AXIS!r}")


# ---------------------------------------------------------------- vision ---

@dataclasses.dataclass
class _VisionCursor:
    payload: np.ndarray             # quantized integer image (H, W, C)
    rid: int
    out: Optional[np.ndarray] = None
    done: bool = False


class VisionAdapter(WorkloadAdapter):
    """Stateless quantized-CNN classification: a request is one image,
    one step is one batched integer forward on the net's device, and every
    admitted request finishes after exactly one step. Images are quantized
    per request with the net's input spec (elementwise, so identical to a
    whole-batch quantize).

    With ``mesh=`` every conv and linear runs on the cluster path
    (`forward_int(mesh=)`), the images data-parallel over ``data`` and
    the output channels over ``model``; the net's packed weights are
    placed on the mesh once (`shard_net`)."""

    name = "vision"
    max_len = 1

    def __init__(self, qnet, *, mesh=None):
        from repro_torch.vision.models import forward_int, shard_net

        self.qnet = qnet
        self.device = qnet.device
        self.mesh = mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the net lives on {self.device}, the mesh "
                             f"on {mesh.device_type} devices")
        self._net = qnet if mesh is None else shard_net(qnet, mesh)
        self._forward = forward_int
        self._spec = ((*qnet.cfg.in_hw, qnet.cfg.in_ch), np.int8)

    def input_spec(self):
        return self._spec

    def step(self, state, feed, positions):
        x = torch.from_numpy(feed).to(self.device)
        logits = self._forward(self._net, x, mesh=self.mesh)
        return logits.cpu().numpy(), state

    def begin(self, payload, *, rid: int, greedy: bool = True,
              seed: int = 0):
        from repro_torch.vision.models import quantize_input

        img = np.asarray(payload, np.float32)
        x_hat = quantize_input(self.qnet, img[None]).cpu().numpy()[0]
        return _VisionCursor(payload=x_hat, rid=rid)

    def reserve_tokens(self, cur) -> int:
        return 1

    def feed(self, cur: _VisionCursor):
        return cur.payload, 0

    def consume(self, cur: _VisionCursor, row) -> bool:
        cur.out = np.asarray(row)
        cur.done = True
        return True

    def result(self, cur: _VisionCursor):
        return cur.out

    def tokens_out(self, cur: _VisionCursor) -> int:
        return 1
