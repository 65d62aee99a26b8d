"""Deterministic synthetic token pipeline with device placement.

A real deployment swaps `SyntheticLM` for a tokenized corpus reader; the
contract the trainer relies on is deterministic per (seed, step) batches
(replayable after a restart: data order survives checkpoint / restore
without persisting reader state, through `seek`) and placement on the
device, or split over a mesh's ``data`` axis. The numpy draws are the
reference's, so its batches and these are byte-identical.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticLM:
    """Zipf-ish token stream with next-token labels, deterministic per
    step. A light Markov flavour (odd positions copy the previous token,
    +0 or +1) gives the loss a learnable structure.

    ``device`` places each batch there (default the card); ``mesh`` splits
    it over the mesh's ``data`` axis as a `parallel.mesh.Sharded` instead.
    ``device=None`` and no mesh keeps numpy arrays."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 device="cuda", mesh=None, src_dim: int = 0,
                 src_len: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.device = (None if device is None or mesh is not None
                       else resolve_device(device))
        self.mesh = mesh
        self.src_dim = src_dim
        self.src_len = src_len
        self._step = 0

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(z, self.vocab - 1).astype(np.int32)
        toks[:, 1::2] = np.minimum(
            toks[:, 0:-1:2] + (rng.integers(0, 2, toks[:, 1::2].shape)),
            self.vocab - 1)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.src_dim:
            batch["src_embed"] = rng.standard_normal(
                (self.batch, self.src_len, self.src_dim)).astype(
                    np.float16) * 0.05
        return batch

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self._batch_at(self._step)
        self._step += 1
        return self.place(batch)

    def place(self, batch: dict) -> dict:
        """Numpy arrays -> tensors on the device, or over the mesh."""
        if self.mesh is not None:
            from repro_torch.parallel.mesh import (NamedSharding, P,
                                                   block_entry, device_put)
            shard = NamedSharding(self.mesh, P(block_entry(self.mesh)))
            return {k: device_put(torch.from_numpy(np.ascontiguousarray(v)),
                                  shard) for k, v in batch.items()}
        if self.device is None:
            return batch
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    @property
    def step(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        self._step = step
